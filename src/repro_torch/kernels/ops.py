"""Public ops: shape plumbing, then dispatch by device.

Each op looks at its input tensor: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor launches the hand-written kernel (or raises). There is
no switch and no fallback. This module owns the cache-dict unpacking and the
static visible window of the attention ops: a slice of a slotted cache, or
the page-table prefix of a paged arena."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention as _decode_attention,
    paged_decode_attention as _paged_decode_attention)
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_attention)
from repro_torch.kernels.int8_matmul import (
    int8_matmul as _int8_matmul, int8_matmul_quant as _int8_matmul_quant)
from repro_torch.kernels.kv_layout import window_pages
from repro_torch.kernels.prefill_attention import (
    paged_prefill_attention as _paged_prefill_attention,
    prefill_attention as _prefill_attention)
from repro_torch.kernels.quantize import quantize_rowwise as _quantize_rowwise

Start = Union[int, torch.Tensor]


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float -> ((..., K) int8, (...,) f32 scale)."""
    shp = x.shape
    q, s = _quantize_rowwise(x.reshape(-1, shp[-1]).contiguous())
    return q.reshape(shp), s.reshape(shp[:-1])


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 matmul: x (..., K) float, quantized per row in the GEMM's own
    launch (``int8_matmul_quant``: B2's codes, then B1), or int8 with
    ``x_scale`` (B1 alone); w_q (K, N) int8 -> (..., N) bf16."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1]).contiguous()
    if x2.dtype == torch.int8:
        out = _int8_matmul(x2, w_q, x_scale.reshape(-1).contiguous(),
                           w_scale)
    else:
        out = _int8_matmul_quant(x2, w_q, w_scale)
    return out.reshape(*shp[:-1], w_q.shape[1])


def _refuse_no_kv_heads(op: str, k: torch.Tensor) -> None:
    """k (..., ..., Hkv, hd), a contiguous or a paged layout. An attention
    layer cut to no head adds zeros and attends nothing (ROADMAP C12), so
    an attend over 0 kv heads is a caller's mistake: refuse it by name
    before the head grouping divides by zero or a grid launches empty."""
    if k.shape[2] == 0:
        raise ValueError(f"{op}: 0 kv heads; an attention layer cut to no "
                         f"head adds zeros and attends nothing")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Causal attention of the train route, differentiable: q (B, S, Hq,
    hd) against k, v (B, S, Hkv, hd), Hq a multiple of Hkv -> (B, S, Hq,
    hd); query i sees positions <= i."""
    _refuse_no_kv_heads("flash_attention", k)
    return _flash_attention(q, k, v)


# ------------------------------------------------------------- KV-cache attn
def _leaves(cache: dict):
    """(k, v, k_s, v_s) of a bf16 or INT8 KV-cache dict."""
    if "k_q" in cache:
        return cache["k_q"], cache["v_q"], cache["k_s"], cache["v_s"]
    return cache["k"], cache["v"], None, None


def _cache_window(cache: dict, window: Optional[int]):
    """(k, v, k_s, v_s) views of a (possibly INT8) KV-cache dict, restricted
    to the first ``window`` positions. The slice is a view: no copy, and the
    kernels take its batch stride. Positions past the window would mask to
    exact zeros, so the windowed attend equals the full one."""
    k, v, k_s, v_s = _leaves(cache)
    if window is not None and window < k.shape[1]:
        sl = lambda t: None if t is None else t[:, :window]
        k, v, k_s, v_s = sl(k), sl(v), sl(k_s), sl(v_s)
    return k, v, k_s, v_s


def _paged_window(cache: dict, pages: torch.Tensor, window: Optional[int]):
    """(k, v, k_s, v_s) of a paged arena (leaves (n_pages, page_size, ...))
    plus the contiguous int32 (B, n_blk) table prefix that covers the static
    ``window``. Positions past a row's limit (the page-rounded tail, trash
    entries) mask to exact zeros, so the paged read equals the contiguous
    one. The engine hands tables already cut to the window, so the prefix
    is then the table itself and no copy is made."""
    k, v, k_s, v_s = _leaves(cache)
    idx = window_pages(pages, k.shape[1], window)
    return k, v, k_s, v_s, idx.to(torch.int32).contiguous()


def _start_vector(start: Start, b: int, device) -> torch.Tensor:
    """Scalar or (B,) start positions -> a contiguous (B,) int32 tensor."""
    if isinstance(start, torch.Tensor):
        start = start.to(device=device, dtype=torch.int32)
        return start.expand(b).contiguous()
    return torch.full((b,), int(start), dtype=torch.int32, device=device)


def prefill_attention(q: torch.Tensor, cache: dict, start: Start,
                      window: Optional[int] = None,
                      pages: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked-prefill attend: q (B, Sq, Hq, hd) at absolute positions
    start..start+Sq-1 against a cache holding [0, start+Sq); ``window >=
    start + Sq`` for every consumed row. Sq == 1 (a prompt's tail chunk)
    stays here, so a tail chunk and a whole-prompt prefill share numerics.
    ``pages`` (B, max_pages) int32 marks the cache as a paged arena."""
    _refuse_no_kv_heads("prefill_attention", _leaves(cache)[0])
    start = _start_vector(start, q.shape[0], q.device)
    if pages is not None:
        k, v, k_s, v_s, idx = _paged_window(cache, pages, window)
        return _paged_prefill_attention(q, k, v, k_s, v_s, start, idx)
    return _prefill_attention(q, *_cache_window(cache, window), start)


def decode_attention(q: torch.Tensor, cache: dict, start: Start,
                     window: Optional[int] = None,
                     pages: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attend: q (B, 1, Hq, hd) at per-slot positions ``start`` ->
    (B, 1, Hq, hd); ``pages`` as in ``prefill_attention``."""
    _refuse_no_kv_heads("decode_attention", _leaves(cache)[0])
    start = _start_vector(start, q.shape[0], q.device)
    if pages is not None:
        k, v, k_s, v_s, idx = _paged_window(cache, pages, window)
        return _paged_decode_attention(q[:, 0], k, v, k_s, v_s, start,
                                       idx)[:, None]
    return _decode_attention(q[:, 0], *_cache_window(cache, window),
                             start)[:, None]
