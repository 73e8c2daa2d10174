"""Decode attention over a slotted KV window or a paged KV arena: the
wrappers of ``csrc/decode_attention.cu`` (replace ``decode_attention_pallas``
and ``paged_decode_attention_pallas``)."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_ATTN_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
              + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float])
KERNEL = build.Kernel("decode_attention", "decode_attention", _ATTN_ARGS)
PAGED_KERNEL = build.Kernel("decode_attention", "paged_decode_attention",
                            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                            + [ctypes.c_float])

HD_MAX, G_MAX = 128, 8
TBL_MAX = 2048                # page-table entries a row (shared memory)


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


def paged_kv_args(name: str, q_heads: int, k: torch.Tensor, v: torch.Tensor,
                  k_s: Optional[torch.Tensor], v_s: Optional[torch.Tensor],
                  start: torch.Tensor, pages: torch.Tensor) -> Tuple:
    """Validate a paged arena (k, v (n_pages, page_size, Hkv, hd) bf16, or
    int8 with (n_pages, page_size, Hkv) f32 scales, all contiguous), the
    (B,) int32 ``start`` and the (B, n_blk) int32 ``pages`` table for the
    paged kernels. The table's values are not read here: that would need a
    host sync. Returns the kernel's arguments (k, v, k_s, v_s, start, pages
    pointers; B, n_blk, page_size, Hkv, G, hd; quantized flag)."""
    dev = k.device
    quantized = k_s is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    build.check(f"{name} k", k, kv_dtype, 4, dev)
    build.check(f"{name} v", v, kv_dtype, 4, dev)
    n_pages, ps, hkv, hd = k.shape
    if v.shape != k.shape or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: k and v must be contiguous arenas of one "
                         f"shape")
    if q_heads % hkv or hd > HD_MAX:
        raise ValueError(f"{name}: {q_heads} q heads over {hkv} kv heads "
                         f"of width {hd}")
    if quantized:
        build.check(f"{name} k_s", k_s, torch.float32, 3, dev)
        build.check(f"{name} v_s", v_s, torch.float32, 3, dev)
        if (k_s.shape != (n_pages, ps, hkv) or v_s.shape != k_s.shape
                or not (k_s.is_contiguous() and v_s.is_contiguous())):
            raise ValueError(f"{name}: scales must be contiguous "
                             f"(n_pages, page_size, Hkv)")
    build.check(f"{name} pages", pages, torch.int32, 2, dev)
    b, n_blk = pages.shape
    if not pages.is_contiguous() or not 1 <= n_blk <= TBL_MAX:
        raise ValueError(f"{name}: pages must be a contiguous (B, n_blk) "
                         f"table with 1 <= n_blk <= {TBL_MAX}, got "
                         f"{tuple(pages.shape)}")
    build.check(f"{name} start", start, torch.int32, 1, dev)
    if start.shape[0] != b or not start.is_contiguous():
        raise ValueError(f"{name}: start must be a contiguous ({b},) tensor")
    build.check_int32(name, b, n_pages, n_blk * ps, hkv * hd)
    return ((k.data_ptr(), v.data_ptr(),
             k_s.data_ptr() if quantized else None,
             v_s.data_ptr() if quantized else None,
             start.data_ptr(), pages.data_ptr()),
            (b, n_blk, ps, hkv, q_heads // hkv, hd), int(quantized))


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_s: Optional[torch.Tensor],
                           v_s: Optional[torch.Tensor], start: torch.Tensor,
                           pages: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd) at per-slot positions ``start`` against a paged arena
    through the (B, n_blk) table prefix ``pages`` -> (B, Hq, hd) bf16: the
    contiguous op on the gathered window of n_blk * page_size positions. A
    CPU tensor takes the plain version."""
    if build.runs_plain(q):
        return ref.paged_decode_attention_ref(q, k, v, k_s, v_s, start, pages)
    build.check("paged_decode_attention q", q, torch.bfloat16, 3, q.device)
    if not q.is_contiguous():
        raise ValueError("paged_decode_attention: q must be contiguous")
    ptrs, (b, n_blk, ps, hkv, g, hd), quantized = paged_kv_args(
        "paged_decode_attention", q.shape[1], k, v, k_s, v_s, start, pages)
    if q.shape != (b, hkv * g, hd) or g > G_MAX:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} "
                         f"against k {tuple(k.shape)}, pages "
                         f"{tuple(pages.shape)}")
    out = torch.empty_like(q)
    PAGED_KERNEL.launch(q.data_ptr(), *ptrs, out.data_ptr(), b, n_blk, ps,
                        hkv, g, hd, quantized, float(hd ** -0.5),
                        stream=build.stream_of(q))
    return out
