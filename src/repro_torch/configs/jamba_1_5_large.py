"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Each 8-layer Jamba block has 1 attention + 7 Mamba layers (attention in the
middle of the block); MoE replaces the MLP every 2 layers. Sub-quadratic
(Mamba state decode): runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

ARCH_ID = "jamba-1.5-large-398b"


def _pattern(n_layers: int):
    # 1:7 attn:mamba — attention at position 4 of every 8-layer block.
    return tuple("attn" if (i % 8 == 4) else "mamba" for i in range(n_layers))


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        block_pattern=_pattern(72),
        moe=MoEConfig(n_experts=16, experts_per_token=2, moe_every=2, moe_offset=1),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        subquadratic=True,
        max_seq_len=262_144,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        block_pattern=("mamba", "attn"),
        moe=MoEConfig(n_experts=4, experts_per_token=2, moe_every=2, moe_offset=1),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, chunk=32),
        subquadratic=True,
        max_seq_len=128,
    )
