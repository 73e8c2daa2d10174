"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP.

[hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Arctic's signature is the dense residual MLP running in parallel with the MoE.

The smoke config's head dim resolves to 64 / 8 = 8, which the card's
attention kernels do not take: it runs on the CPU; the card runs the
published widths (head dim 128).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "arctic-480b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        moe=MoEConfig(n_experts=128, experts_per_token=2, moe_every=1,
                      dense_residual=True),
        max_seq_len=4_096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        moe=MoEConfig(n_experts=4, experts_per_token=2, moe_every=1,
                      dense_residual=True),
        max_seq_len=128,
    )
