"""Target hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates without sparsity, at the 700 W power limit)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_bf16: float        # FLOP/s
    peak_int8: float        # OP/s
    hbm_bw: float           # B/s
    hbm_bytes: float
    nvlink_bw: float        # B/s, one direction


H100_SXM = Chip(
    name="h100_sxm",
    peak_bf16=989.4e12,
    peak_int8=1978.9e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    nvlink_bw=450e9,
)
