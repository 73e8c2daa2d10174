"""Decode attention over a slotted KV window or a paged KV arena: the
wrappers of ``csrc/decode_attention.cu`` (replace ``decode_attention_pallas``
and ``paged_decode_attention_pallas``), and their launch plan.

``decode_plan`` is the host side of the kernel's split-KV: the KV axis cut
into segments of SEG positions at absolute boundaries, one block a (kv head,
segment, slot). A slot whose visible positions span several segments folds
their partial results inside the one launch, through a per-device workspace
of f32 records behind int32 tickets that the kernel leaves at zero after
every launch. The workspace is made once, with ``torch.zeros``, at a size
that holds every split of the model's decode shapes at 4 slots up to its
40,960 positions, and no buffer is ever freed (``build.Workspaces``).

``kv_args``, ``paged_kv_args`` and ``check_launch`` also validate the
chunked-prefill kernels' arguments (``prefill_attention.py``)."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import cost

KERNEL = build.Kernel("decode_attention", "decode_attention",
                      [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int, ctypes.c_float, ctypes.c_int])
PAGED_KERNEL = build.Kernel("decode_attention", "paged_decode_attention",
                            [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                            + [ctypes.c_int] * 7
                            + [ctypes.c_float, ctypes.c_int])

# Mirrors csrc/decode_attention.cu: positions a segment (a block of four
# warps, one 64-position tile each), query heads a kv head (one m16 tile),
# and the int32 tickets ahead of the workspace records. The kernel refuses a
# plan whose segment count or workspace do not match its own.
SEG, BKV = 256, 64
G_MAX = 16
HEAD_DIMS = (16, 32, 64, 96, 128)   # the kernel's instances: 16 the smoke
                                    # config, 64 the repo's qwen3-0.6b, 96
                                    # phi-3-vision, 128 the published qwen3
TICKETS = 8192
# 4-byte elements of the first workspace: the tickets and the records of 4
# slots of qwen3-0.6b (8 kv heads, G 2, hd 64) over its 40,960 positions
WORKSPACE_MIN = TICKETS + 4 * 8 * (40960 // SEG) * (2 * 64 + 4)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def record_floats(g: int, hd: int) -> int:
    """f32 elements of a segment's workspace record: the partial output (G,
    hd), then its running max and sum (G each), padded to 16 bytes."""
    return g * hd + (2 * g + 3) // 4 * 4


@dataclass(frozen=True)
class DecodePlan:
    grid: Tuple[int, int, int]      # (Hkv, segments, B)
    workspace: int                  # 4-byte elements (0: one segment)

    @property
    def segments(self) -> int:
        return self.grid[1]


def decode_plan(b: int, w: int, hkv: int, g: int, hd: int) -> DecodePlan:
    """The launch of B slots against a W-position window: one block per (kv
    head, segment, slot). With more than one segment the workspace holds
    the tickets and one record per (slot, kv head, segment)."""
    n_seg = _cdiv(w, SEG)
    ws = TICKETS + b * hkv * n_seg * record_floats(g, hd) if n_seg > 1 else 0
    return DecodePlan(grid=(hkv, n_seg, b), workspace=ws)


# the split-KV workspaces of each device; none is freed
WORKSPACES = build.Workspaces("decode_attention: a split-KV workspace",
                              WORKSPACE_MIN)


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
    if q_heads % hkv:
        raise ValueError(f"{name}: {q_heads} q heads over {hkv} kv heads")
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


def check_launch(name: str, q: torch.Tensor, k: torch.Tensor, g: int,
                 hd: int, g_max: int) -> None:
    """What the attention kernels take beyond the KV checks: their head
    dims, at most ``g_max`` query heads a kv head, q read two values at a
    time and K/V copied 16 bytes at a time."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if g > g_max:
        raise ValueError(f"{name}: {g} query heads a kv head, at most "
                         f"{g_max}")
    if q.data_ptr() % 4:
        raise ValueError(f"{name}: q must start 4-byte aligned")
    if k.data_ptr() % 16 or (k.stride(0) * k.element_size()) % 16:
        raise ValueError(f"{name}: k/v must start 16-byte aligned with a "
                         f"batch stride of a multiple of 16 bytes")


def _workspace(name: str, q: torch.Tensor, plan: DecodePlan) -> Tuple:
    """(pointer, length) of the workspace a plan needs, (None, 0) if none."""
    if not plan.workspace:
        return None, 0
    hkv, _, b = plan.grid
    if b * hkv > TICKETS:
        raise ValueError(f"{name}: {b} slots of {hkv} kv heads over more "
                         f"than one segment; the kernel takes at most "
                         f"{TICKETS} (slot, kv head) pairs")
    ws = WORKSPACES.get(q.device, plan.workspace,
                        torch.cuda.is_current_stream_capturing)
    return ws.data_ptr(), ws.numel()


def attend_count(out, q, k, v, k_s, v_s, start, pages=None):
    """The count of an attend of q (B, [Sq,] Hq, hd) over the window it is
    handed: W positions of a (B, W, Hkv, hd) window, or n_blk * page_size
    of a paged arena through a (B, n_blk) table. QK and PV, 2·W·hd flops
    each a query row, in bf16 (INT8 K/V is dequantized before its
    products); bytes: q, the window's K/V (and scales), start, the table
    and the output once."""
    kv = [t for t in (k, v, k_s, v_s) if t is not None]
    if pages is None:
        w, kv_bytes = k.shape[1], cost.nbytes(kv)
    else:
        w = pages.shape[1] * k.shape[1]
        kv_bytes = sum(t[0, 0].numel() * t.element_size() * q.shape[0] * w
                       for t in kv)
    rows = q.numel() // q.shape[-1]
    return (4 * rows * w * q.shape[-1], 0,
            kv_bytes + cost.nbytes(q, start, pages, out))


@cost.boundary(attend_count)
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_s: Optional[torch.Tensor], v_s: Optional[torch.Tensor],
                     start: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd) at per-slot positions ``start`` (B,) int32 against a
    (B, W, Hkv, hd) window -> (B, Hq, hd) bf16; a slot sees positions
    <= start that lie in the window. A CPU tensor takes the plain version;
    on the card hd must be in HEAD_DIMS and Hq / Hkv at most G_MAX."""
    if build.runs_plain(q):
        return ref.decode_attention_ref(q, k, v, k_s, v_s, start)
    build.check("decode_attention q", q, torch.bfloat16, 3, q.device)
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    ptrs, (b, w, hkv, g, hd), strides, quantized = kv_args(
        "decode_attention", q.shape[1], k, v, k_s, v_s, start)
    if q.shape != (b, hkv * g, hd):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"k {tuple(k.shape)}")
    check_launch("decode_attention", q, k, g, hd, G_MAX)
    plan = decode_plan(b, w, hkv, g, hd)
    ws = _workspace("decode_attention", q, plan)
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), *ptrs, start.data_ptr(), out.data_ptr(),
                  *ws, b, w, hkv, g, hd, *strides, quantized,
                  float(hd ** -0.5), plan.segments,
                  stream=build.stream_of(q))
    return out


def paged_kv_args(name: str, q_heads: int, k: torch.Tensor, v: torch.Tensor,
                  k_s: Optional[torch.Tensor], v_s: Optional[torch.Tensor],
                  start: torch.Tensor, pages: torch.Tensor) -> Tuple:
    """Validate a paged arena (k, v (n_pages, page_size, Hkv, hd) bf16, or
    int8 with (n_pages, page_size, Hkv) f32 scales, all contiguous), the
    (B,) int32 ``start`` and the (B, n_blk) int32 ``pages`` table for the
    paged kernels, a table of any length. The table's values are not read
    here: that would need a host sync. Returns the kernel's arguments (k,
    v, k_s, v_s, start, pages pointers; B, n_blk, page_size, Hkv, G, hd;
    quantized flag)."""
    dev = k.device
    quantized = k_s is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    build.check(f"{name} k", k, kv_dtype, 4, dev)
    build.check(f"{name} v", v, kv_dtype, 4, dev)
    n_pages, ps, hkv, hd = k.shape
    if v.shape != k.shape or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: k and v must be contiguous arenas of one "
                         f"shape")
    if q_heads % hkv:
        raise ValueError(f"{name}: {q_heads} q heads over {hkv} kv heads")
    if quantized:
        build.check(f"{name} k_s", k_s, torch.float32, 3, dev)
        build.check(f"{name} v_s", v_s, torch.float32, 3, dev)
        if (k_s.shape != (n_pages, ps, hkv) or v_s.shape != k_s.shape
                or not (k_s.is_contiguous() and v_s.is_contiguous())):
            raise ValueError(f"{name}: scales must be contiguous "
                             f"(n_pages, page_size, Hkv)")
    build.check(f"{name} pages", pages, torch.int32, 2, dev)
    b, n_blk = pages.shape
    if not pages.is_contiguous() or n_blk < 1:
        raise ValueError(f"{name}: pages must be a contiguous (B, n_blk) "
                         f"table with 1 <= n_blk, got {tuple(pages.shape)}")
    build.check(f"{name} start", start, torch.int32, 1, dev)
    if start.shape[0] != b or not start.is_contiguous():
        raise ValueError(f"{name}: start must be a contiguous ({b},) tensor")
    build.check_int32(name, b, n_pages * ps, n_blk * ps, hkv * hd)
    return ((k.data_ptr(), v.data_ptr(),
             k_s.data_ptr() if quantized else None,
             v_s.data_ptr() if quantized else None,
             start.data_ptr(), pages.data_ptr()),
            (b, n_blk, ps, hkv, q_heads // hkv, hd), int(quantized))


@cost.boundary(attend_count)
def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_s: Optional[torch.Tensor],
                           v_s: Optional[torch.Tensor], start: torch.Tensor,
                           pages: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd) at per-slot positions ``start`` against a paged arena
    through the (B, n_blk) table prefix ``pages``, of any length -> (B, Hq,
    hd) bf16: the contiguous op on the gathered window of n_blk * page_size
    positions, bit for bit. A CPU tensor takes the plain version; on the
    card hd and G as for ``decode_attention``."""
    if build.runs_plain(q):
        return ref.paged_decode_attention_ref(q, k, v, k_s, v_s, start, pages)
    build.check("paged_decode_attention q", q, torch.bfloat16, 3, q.device)
    if not q.is_contiguous():
        raise ValueError("paged_decode_attention: q must be contiguous")
    ptrs, (b, n_blk, ps, hkv, g, hd), quantized = paged_kv_args(
        "paged_decode_attention", q.shape[1], k, v, k_s, v_s, start, pages)
    if q.shape != (b, hkv * g, hd):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} "
                         f"against k {tuple(k.shape)}, pages "
                         f"{tuple(pages.shape)}")
    check_launch("paged_decode_attention", q, k, g, hd, G_MAX)
    plan = decode_plan(b, n_blk * ps, hkv, g, hd)
    ws = _workspace("paged_decode_attention", q, plan)
    out = torch.empty_like(q)
    PAGED_KERNEL.launch(q.data_ptr(), *ptrs, out.data_ptr(), *ws, b, n_blk,
                        ps, hkv, g, hd, quantized, float(hd ** -0.5),
                        plan.segments, stream=build.stream_of(q))
    return out
