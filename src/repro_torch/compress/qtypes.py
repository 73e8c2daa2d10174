"""Typed quantized-parameter container (the HQP artifact's leaf type).

Model code dispatches on the type (``layers.dense``), never on dict keys."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    """INT8 linear weight: ``w_q`` (..., in, out) int8 and per-out-channel
    ``scale`` (..., out) f32. ``x ≈ (x_q @ w_q) * x_scale * scale``: the
    dequant lives in the matmul epilogue, the FP weight never exists."""
    w_q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    def to(self, device) -> "QuantizedLinear":
        return QuantizedLinear(self.w_q.to(device), self.scale.to(device),
                               self.bits)


def linear_kernel(p: Any) -> torch.Tensor:
    """The weight tensor of a (possibly quantized) linear, for deriving
    widths from shapes (head counts of HQP-compacted params)."""
    return p.w_q if isinstance(p, QuantizedLinear) else p["w"]


def out_features(p: Any) -> int:
    return linear_kernel(p).shape[-1]


def linear_bytes(p: Any) -> int:
    if isinstance(p, QuantizedLinear):
        return p.w_q.numel() * p.w_q.element_size() + p.scale.numel() * 4
    return p["w"].numel() * p["w"].element_size()
