"""Rowwise symmetric INT8 activation quantization: the wrapper of
``csrc/quantize_rowwise.cu`` (replaces ``quantize_rowwise_pallas``)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import cost

KERNEL = build.Kernel("quantize_rowwise", "quantize_rowwise",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)


def _count(out, x):
    return 0, 0, cost.nbytes(x, out)


@cost.boundary(_count)
def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> ((M, K) int8, (M,) f32 scales). A CPU tensor takes the
    plain version; a CUDA tensor must be contiguous bf16."""
    if build.runs_plain(x):
        return ref.quantize_ref(x, dim=-1)
    build.check("quantize_rowwise x", x, torch.bfloat16, 2, x.device)
    if not x.is_contiguous():
        raise ValueError("quantize_rowwise: x must be contiguous")
    m, k = x.shape
    build.check_int32("quantize_rowwise", m, k)
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    KERNEL.launch(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
                  stream=build.stream_of(x))
    return q, s
