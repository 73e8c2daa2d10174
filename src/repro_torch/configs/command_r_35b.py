"""command-r-35b [dense] — GQA, no-bias.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

The smoke config's head dim resolves to 64 / 8 = 8, which the card's
attention kernels do not take: it runs on the CPU; the card runs the
published widths (head dim 128).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "command-r-35b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        use_bias=False,
        tie_embeddings=True,
        rope_theta=8_000_000.0,
        max_seq_len=131_072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        tie_embeddings=True,
        max_seq_len=128,
    )
