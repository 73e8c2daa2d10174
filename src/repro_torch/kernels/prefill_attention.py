"""Chunked-prefill attention over a slotted KV window or a paged KV arena:
the wrappers of ``csrc/prefill_attention.cu`` (replace
``prefill_attention_pallas`` and ``paged_prefill_attention_pallas``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import kv_args, paged_kv_args

KERNEL = build.Kernel("prefill_attention", "prefill_attention",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                      + [ctypes.c_longlong] * 2
                      + [ctypes.c_int, ctypes.c_float])

PAGED_KERNEL = build.Kernel("prefill_attention", "paged_prefill_attention",
                            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                            + [ctypes.c_float])

G_MAX = 32


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_s: Optional[torch.Tensor], v_s: Optional[torch.Tensor],
                      start: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, Hq, hd) at absolute positions start..start+Sq-1 (start (B,)
    int32) against a (B, W, Hkv, hd) window -> (B, Sq, Hq, hd) bf16. Row i
    sees positions <= start + i that lie in the window. A CPU tensor takes
    the plain version."""
    if build.runs_plain(q):
        return ref.cached_attention_ref(q, k, v, k_s, v_s, start)
    build.check("prefill_attention q", q, torch.bfloat16, 4, q.device)
    if not q.is_contiguous():
        raise ValueError("prefill_attention: q must be contiguous")
    ptrs, (b, w, hkv, g, hd), strides, quantized = kv_args(
        "prefill_attention", q.shape[2], k, v, k_s, v_s, start)
    sq = q.shape[1]
    if q.shape != (b, sq, hkv * g, hd) or g > G_MAX:
        raise ValueError(f"prefill_attention: q {tuple(q.shape)} against "
                         f"k {tuple(k.shape)}")
    build.check_int32("prefill_attention", sq)
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), *ptrs, start.data_ptr(), out.data_ptr(),
                  b, sq, w, hkv, g, hd, *strides, quantized,
                  float(hd ** -0.5), stream=build.stream_of(q))
    return out


def paged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_s: Optional[torch.Tensor],
                            v_s: Optional[torch.Tensor], start: torch.Tensor,
                            pages: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, Hq, hd) at start..start+Sq-1 against a paged arena through
    the (B, n_blk) table prefix ``pages`` -> (B, Sq, Hq, hd) bf16: the
    contiguous op on the gathered window of n_blk * page_size positions. A
    CPU tensor takes the plain version."""
    if build.runs_plain(q):
        return ref.paged_prefill_attention_ref(q, k, v, k_s, v_s, start,
                                               pages)
    build.check("paged_prefill_attention q", q, torch.bfloat16, 4, q.device)
    if not q.is_contiguous():
        raise ValueError("paged_prefill_attention: q must be contiguous")
    ptrs, (b, n_blk, ps, hkv, g, hd), quantized = paged_kv_args(
        "paged_prefill_attention", q.shape[2], k, v, k_s, v_s, start, pages)
    sq = q.shape[1]
    if q.shape != (b, sq, hkv * g, hd) or g > G_MAX:
        raise ValueError(f"paged_prefill_attention: q {tuple(q.shape)} "
                         f"against k {tuple(k.shape)}, pages "
                         f"{tuple(pages.shape)}")
    build.check_int32("paged_prefill_attention", sq)
    out = torch.empty_like(q)
    PAGED_KERNEL.launch(q.data_ptr(), *ptrs, out.data_ptr(), b, sq, n_blk,
                        ps, hkv, g, hd, quantized, float(hd ** -0.5),
                        stream=build.stream_of(q))
    return out
