"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        moe=MoEConfig(n_experts=16, experts_per_token=2, moe_every=1),
        max_seq_len=131_072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        moe=MoEConfig(n_experts=4, experts_per_token=2, moe_every=1),
        max_seq_len=128,
    )
