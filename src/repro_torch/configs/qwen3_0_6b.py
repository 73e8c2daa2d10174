"""qwen3-0.6b [dense] — qk_norm, GQA. 28L d_model=1024 16H (GQA kv=8)
d_ff=3072 vocab=151936.

``head_dim`` is left unset, as in the JAX package's config, so it resolves
to 1024/16 = 64 (the published checkpoint uses 128): the port computes what
the reference computes."""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-0.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        max_seq_len=40_960,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qk_norm=True,
        tie_embeddings=True,
        max_seq_len=128,
    )
