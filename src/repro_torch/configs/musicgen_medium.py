"""musicgen-medium [audio] — a decoder-only transformer over EnCodec
tokens. 48L d_model=1536 24H (GQA kv=24, hd 64) d_ff=6144 vocab=2048.

The EnCodec frontend is a stub, as in the JAX package's config: the
caller passes precomputed conditioning frame embeddings (256 frames, at
d_model), which the model's ``frontend`` linear maps and prepends to the
codec-token stream."""
from repro_torch.configs.base import FrontendConfig, ModelConfig

ARCH_ID = "musicgen-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        frontend=FrontendConfig(kind="encodec_frames", n_embeds=256,
                                embed_dim=1536),
        max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        frontend=FrontendConfig(kind="encodec_frames", n_embeds=8,
                                embed_dim=64),
        max_seq_len=128,
    )
