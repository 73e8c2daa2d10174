"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]).

[arXiv:2405.04517; unverified]
48L d_model=2048 4H d_ff=0 vocab=50304. No FFN (d_ff=0): the per-block
up-projections carry the capacity. Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

ARCH_ID = "xlstm-1.3b"


def _pattern(n_layers: int, slstm_every: int):
    # xLSTM[7:1]: one sLSTM block per 8, placed at the end of each group.
    return tuple(
        "slstm" if (i % slstm_every == slstm_every - 1) else "mlstm"
        for i in range(n_layers)
    )


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=_pattern(48, 8),
        xlstm=XLSTMConfig(slstm_every=8),
        subquadratic=True,
        max_seq_len=1_048_576,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=256,
        block_pattern=("mlstm", "slstm"),
        xlstm=XLSTMConfig(slstm_every=2, chunk=32),
        subquadratic=True,
        max_seq_len=128,
    )
