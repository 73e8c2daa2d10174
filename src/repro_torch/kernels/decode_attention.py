"""Decode attention over a slotted KV window: the wrapper of
``csrc/decode_attention.cu`` (replaces ``decode_attention_pallas``)."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_ATTN_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
              + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float])
KERNEL = build.Kernel("decode_attention", "decode_attention", _ATTN_ARGS)

HD_MAX, G_MAX = 128, 8


def kv_args(name: str, q_heads: int, k: torch.Tensor, v: torch.Tensor,
            k_s: Optional[torch.Tensor], v_s: Optional[torch.Tensor],
            start: torch.Tensor) -> Tuple:
    """Validate a (B, W, Hkv, hd) KV window (bf16, or int8 with (B, W, Hkv)
    f32 scales) for the attention kernels. The window may be a slice of a
    longer cache along W: only the last three dims must be contiguous, and
    the batch stride is passed to the kernel. Returns the kernel's KV
    arguments (k, v, k_s, v_s pointers, sizes, strides, quantized flag)."""
    dev = k.device
    quantized = k_s is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    build.check(f"{name} k", k, kv_dtype, 4, dev)
    build.check(f"{name} v", v, kv_dtype, 4, dev)
    b, w, hkv, hd = k.shape
    if v.shape != k.shape or v.stride() != k.stride():
        raise ValueError(f"{name}: k and v differ in shape or layout")
    if k.stride()[1:] != (hkv * hd, hd, 1):
        raise ValueError(f"{name}: the (W, Hkv, hd) dims of k/v must be "
                         f"contiguous, got strides {k.stride()}")
    if q_heads % hkv or hd > HD_MAX:
        raise ValueError(f"{name}: {q_heads} q heads over {hkv} kv heads "
                         f"of width {hd}")
    s_stride = 0
    if quantized:
        build.check(f"{name} k_s", k_s, torch.float32, 3, dev)
        build.check(f"{name} v_s", v_s, torch.float32, 3, dev)
        if (k_s.shape != (b, w, hkv) or v_s.shape != k_s.shape
                or v_s.stride() != k_s.stride()
                or k_s.stride()[1:] != (hkv, 1)):
            raise ValueError(f"{name}: scales must be (B, W, Hkv) with the "
                             f"last two dims contiguous")
        s_stride = k_s.stride(0)
    build.check(f"{name} start", start, torch.int32, 1, dev)
    if start.shape[0] != b or not start.is_contiguous():
        raise ValueError(f"{name}: start must be a contiguous ({b},) tensor")
    build.check_int32(name, b, w, hkv * hd)
    return ((k.data_ptr(), v.data_ptr(),
             k_s.data_ptr() if quantized else None,
             v_s.data_ptr() if quantized else None),
            (b, w, hkv, q_heads // hkv, hd),
            (k.stride(0), s_stride), int(quantized))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_s: Optional[torch.Tensor], v_s: Optional[torch.Tensor],
                     start: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd) at per-slot positions ``start`` (B,) int32 against a
    (B, W, Hkv, hd) window -> (B, Hq, hd) bf16; a slot sees positions
    <= start that lie in the window. A CPU tensor takes the plain version."""
    if build.runs_plain(q):
        return ref.decode_attention_ref(q, k, v, k_s, v_s, start)
    build.check("decode_attention q", q, torch.bfloat16, 3, q.device)
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    ptrs, (b, w, hkv, g, hd), strides, quantized = kv_args(
        "decode_attention", q.shape[1], k, v, k_s, v_s, start)
    if q.shape != (b, hkv * g, hd) or g > G_MAX:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"k {tuple(k.shape)}")
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), *ptrs, start.data_ptr(), out.data_ptr(),
                  b, w, hkv, g, hd, *strides, quantized, float(hd ** -0.5),
                  stream=build.stream_of(q))
    return out
