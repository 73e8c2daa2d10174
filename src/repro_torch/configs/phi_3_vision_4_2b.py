"""phi-3-vision-4.2b [vlm] — the phi3-mini backbone behind a CLIP image
tower. 32L d_model=3072 32H (GQA kv=32, hd 96) d_ff=8192 vocab=32064.

The image tower is a stub, as in the JAX package's config: the caller
passes precomputed patch embeddings (576 patches of a 336 px ViT-L/14
crop, already at d_model), which the model's ``frontend`` linear maps
and prepends to the token stream."""
from repro_torch.configs.base import FrontendConfig, ModelConfig

ARCH_ID = "phi-3-vision-4.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        rope_theta=10_000.0,
        frontend=FrontendConfig(kind="clip_patches", n_embeds=576,
                                embed_dim=3072),
        max_seq_len=131_072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        frontend=FrontendConfig(kind="clip_patches", n_embeds=8,
                                embed_dim=64),
        max_seq_len=128,
    )
