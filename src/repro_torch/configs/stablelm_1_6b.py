"""stablelm-1.6b [dense].

[hf:stabilityai/stablelm-2-1_6b; unverified]
24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "stablelm-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        max_seq_len=4_096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        max_seq_len=128,
    )
