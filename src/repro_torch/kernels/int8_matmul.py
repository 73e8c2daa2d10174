"""W8A8 matmul with the dequant epilogue: the wrapper of
``csrc/int8_matmul.cu`` (replaces ``int8_matmul_pallas``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

KERNEL = build.Kernel("int8_matmul", "int8_matmul",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8, x_scale (M,) f32, w_scale (N,) f32
    -> (M, N) bf16. A CPU tensor takes the plain version; CUDA tensors must
    be contiguous and on one device."""
    if build.runs_plain(x_q):
        return ref.int8_matmul_ref(x_q, w_q, x_scale, w_scale)
    dev = x_q.device
    build.check("int8_matmul x_q", x_q, torch.int8, 2, dev)
    build.check("int8_matmul w_q", w_q, torch.int8, 2, dev)
    build.check("int8_matmul x_scale", x_scale, torch.float32, 1, dev)
    build.check("int8_matmul w_scale", w_scale, torch.float32, 1, dev)
    m, k = x_q.shape
    n = w_q.shape[1]
    if w_q.shape[0] != k or x_scale.shape[0] != m or w_scale.shape[0] != n:
        raise ValueError(f"int8_matmul: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} with scales "
                         f"{tuple(x_scale.shape)}, {tuple(w_scale.shape)}")
    if not all(t.is_contiguous() for t in (x_q, w_q, x_scale, w_scale)):
        raise ValueError("int8_matmul: inputs must be contiguous")
    build.check_int32("int8_matmul", m, n, k)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    KERNEL.launch(x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                  w_scale.data_ptr(), out.data_ptr(), m, n, k,
                  stream=build.stream_of(x_q))
    return out
