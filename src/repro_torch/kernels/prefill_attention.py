"""Chunked-prefill attention over a slotted KV window or a paged KV arena:
the wrappers of ``csrc/prefill_attention.cu`` (replace
``prefill_attention_pallas`` and ``paged_prefill_attention_pallas``).

``prefill_plan`` is the host side of the kernel's tiling: the warps a block
and the grid, which is all the launch passes. The kernel keeps its own tile
constants and shared-memory size."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import (attend_count,
                                                  check_launch, kv_args,
                                                  paged_kv_args)
from repro_torch.roofline import cost

KERNEL = build.Kernel("prefill_attention", "prefill_attention",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                      + [ctypes.c_longlong] * 2
                      + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 2)

PAGED_KERNEL = build.Kernel("prefill_attention", "paged_prefill_attention",
                            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                            + [ctypes.c_float] + [ctypes.c_int] * 2)

G_MAX = 32
ROWS_PER_WARP = 16              # one m16 MMA tile, as in the kernel
MAX_WARPS = 4


@dataclass(frozen=True)
class PrefillPlan:
    warps: int                      # a block's warps: 16 rows each
    grid: Tuple[int, int, int]      # (Hkv, query tiles, B)


def prefill_plan(b: int, sq: int, hkv: int, g: int) -> PrefillPlan:
    """The launch: as few warps as hold the chunk's Sq * G rows (at least
    ceil(G / 16), so that a block takes one whole query, at most 4), a block
    taking floor(16 * warps / G) queries; one block per (kv head, query
    tile, slot). The serve chunk (16 queries, G = 2) is one 2-warp block a
    kv head."""
    need = -(-sq * g // ROWS_PER_WARP)
    warps = min(MAX_WARPS, max(need, -(-g // ROWS_PER_WARP)))
    bq = ROWS_PER_WARP * warps // g
    return PrefillPlan(warps=warps, grid=(hkv, -(-sq // bq), b))


@cost.boundary(attend_count)
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
    if q.shape != (b, sq, hkv * g, hd):
        raise ValueError(f"prefill_attention: q {tuple(q.shape)} against "
                         f"k {tuple(k.shape)}")
    check_launch("prefill_attention", q, k, g, hd, G_MAX)
    build.check_int32("prefill_attention", sq)
    plan = prefill_plan(b, sq, hkv, g)
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), *ptrs, start.data_ptr(), out.data_ptr(),
                  b, sq, w, hkv, g, hd, *strides, quantized,
                  float(hd ** -0.5), plan.warps, plan.grid[1],
                  stream=build.stream_of(q))
    return out


@cost.boundary(attend_count)
def paged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_s: Optional[torch.Tensor],
                            v_s: Optional[torch.Tensor], start: torch.Tensor,
                            pages: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, Hq, hd) at start..start+Sq-1 against a paged arena through
    the (B, n_blk) table prefix ``pages``, of any length -> (B, Sq, Hq, hd)
    bf16: the contiguous op on the gathered window of n_blk * page_size
    positions. A CPU tensor takes the plain version."""
    if build.runs_plain(q):
        return ref.paged_prefill_attention_ref(q, k, v, k_s, v_s, start,
                                               pages)
    build.check("paged_prefill_attention q", q, torch.bfloat16, 4, q.device)
    if not q.is_contiguous():
        raise ValueError("paged_prefill_attention: q must be contiguous")
    ptrs, (b, n_blk, ps, hkv, g, hd), quantized = paged_kv_args(
        "paged_prefill_attention", q.shape[2], k, v, k_s, v_s, start, pages)
    sq = q.shape[1]
    if q.shape != (b, sq, hkv * g, hd):
        raise ValueError(f"paged_prefill_attention: q {tuple(q.shape)} "
                         f"against k {tuple(k.shape)}, pages "
                         f"{tuple(pages.shape)}")
    check_launch("paged_prefill_attention", q, k, g, hd, G_MAX)
    build.check_int32("paged_prefill_attention", sq)
    plan = prefill_plan(b, sq, hkv, g)
    out = torch.empty_like(q)
    PAGED_KERNEL.launch(q.data_ptr(), *ptrs, out.data_ptr(), b, sq, n_blk,
                        ps, hkv, g, hd, quantized, float(hd ** -0.5),
                        plan.warps, plan.grid[1], stream=build.stream_of(q))
    return out
