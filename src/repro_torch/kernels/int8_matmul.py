"""W8A8 matmul with the dequant epilogue: the wrappers of
``csrc/int8_matmul.cu`` (replaces ``int8_matmul_pallas``; its second form,
``int8_matmul_quant``, also ``quantize_rowwise_pallas``, as the prologue of
the same launch), and their launch plan.

``gemm_plan`` is the host side of the kernel's tiling, in plain Python so
that the CPU tests reach it: 16-row M tiles, 32-column N tiles, K split over
``grid.z`` so that a decode shape fills the card's 132 SMs, the weight copy
width from the alignment of N and of the pointer, and the dynamic shared
memory. A split K reduces its int32 partial sums inside the one launch,
through a per-device workspace that the kernel leaves zeroed after every
launch. The workspace is made once, with ``torch.zeros``, at a size that
holds every product of fewer tiles than the card has SMs (every split of the
model's shapes), and no buffer is ever freed, so a CUDA graph that captured
a launch keeps a valid pointer. Launches on one device share it, so they
must run in stream order, as the port's single stream does."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import cost

KERNEL = build.Kernel("int8_matmul", "int8_matmul",
                      [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 8)
# the same kernel from a bf16 x that it quantizes per row itself
QUANT_KERNEL = build.Kernel("int8_matmul", "int8_matmul_quant",
                            [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8)

# Mirrors csrc/int8_matmul.cu: tile rows and columns, k rows a warp takes
# per step, warps, ring stages. The kernel refuses a plan whose K ranges,
# shared memory or workspace do not match its own tiling.
BM, BN, KSTEP, WARPS, STAGES = 16, 32, 32, 4, 4
RING_BYTES = STAGES * KSTEP * WARPS * BN
N_SMS = 132                 # H100 SXM
X_TILE_MAX = 64 * 1024      # bytes of x a block stages; longer K ranges split
# int32 elements of the first workspace: the sums and counters of any
# product of fewer than N_SMS tiles
WORKSPACE_MIN = N_SMS * (BM * BN + 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def copy_width(pitch: int, ptr: int) -> int:
    """The widest copy (16, 8 or 4 bytes, else 1) that divides a row pitch
    and the pointer, so that each copy starts on its own alignment."""
    for v in (16, 8, 4):
        if pitch % v == 0 and ptr % v == 0:
            return v
    return 1


@dataclass(frozen=True)
class GemmPlan:
    m_tiles: int
    n_tiles: int
    split: int          # K ranges (grid.z)
    ksteps: int         # 32-row steps in each K range (the last may be short)
    vec: int            # weight copy width, bytes
    x_vec: int          # x load width, bytes: int8 x 4 or 1, bf16 x 16 or 2
    smem: int           # dynamic shared memory, bytes
    workspace: int      # int32 elements of the split-K workspace (0: none)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.n_tiles, self.m_tiles, self.split

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.m_tiles * self.split

    def k_ranges(self, k: int) -> List[Tuple[int, int]]:
        step = self.ksteps * KSTEP
        return [(z * step, min(k, (z + 1) * step)) for z in range(self.split)]


def x_width(k: int, x_ptr: int, x_bytes: int) -> int:
    """The widest load of x's rows: 4 bytes of int8 x (``x_bytes`` 1) or
    16 of bf16 x (``x_bytes`` 2, 8 values) where every row starts on that
    width (K a multiple of the values a load takes, x's pointer aligned);
    else one element."""
    v = 4 if x_bytes == 1 else 16
    return v if k % (v // x_bytes) == 0 and x_ptr % v == 0 else x_bytes


def gemm_plan(m: int, n: int, k: int, w_ptr: int = 0, x_ptr: int = 0,
              x_bytes: int = 1) -> GemmPlan:
    """The launch of an (m, k) x (k, n) product from an int8 x
    (``x_bytes`` 1) or from a bf16 x that the launch quantizes (2). K is
    cut into as many ranges of whole 32-row steps as it takes to give at
    least N_SMS blocks (rounding the steps a range takes down, so the count
    errs high), and never so long that x's staged tile passes X_TILE_MAX.
    The shared memory is the weight ring and x's int8 tile, plus, for a
    bf16 x, one f32 scale a tile row. Both forms take the same grid: the
    quantize prologue reads each row over all of K in every block, from L2
    after the first."""
    m_tiles, n_tiles = _cdiv(m, BM), _cdiv(n, BN)
    ksteps_all = max(1, _cdiv(k, KSTEP))
    want = _cdiv(N_SMS, m_tiles * n_tiles)
    per = max(1, ksteps_all // want)
    per = min(per, (X_TILE_MAX // BM - 16) // KSTEP)
    split = _cdiv(ksteps_all, per)
    x_pitch = per * KSTEP + 16
    return GemmPlan(
        m_tiles=m_tiles, n_tiles=n_tiles, split=split, ksteps=per,
        vec=copy_width(n, w_ptr), x_vec=x_width(k, x_ptr, x_bytes),
        smem=RING_BYTES + BM * x_pitch + (BM * 4 if x_bytes == 2 else 0),
        workspace=m * n + m_tiles * n_tiles if split > 1 else 0)


# the split-K workspaces of each device; none is freed
WORKSPACES = build.Workspaces("int8_matmul: a split-K workspace",
                              WORKSPACE_MIN)


def _workspace(dev, plan: GemmPlan):
    return (WORKSPACES.get(dev, plan.workspace,
                           torch.cuda.is_current_stream_capturing)
            if plan.workspace else None)


def _check_weights(name: str, w_q: torch.Tensor, w_scale: torch.Tensor,
                   dev, k: int) -> int:
    build.check(f"{name} w_q", w_q, torch.int8, 2, dev)
    build.check(f"{name} w_scale", w_scale, torch.float32, 1, dev)
    n = w_q.shape[1]
    if w_q.shape[0] != k or w_scale.shape[0] != n:
        raise ValueError(f"{name}: w_q {tuple(w_q.shape)}, w_scale "
                         f"{tuple(w_scale.shape)} against K = {k}")
    if not (w_q.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    return n


def _count(out, x, w_q, *rest, **kw):
    """2·M·K·N INT8, and every operand and result once."""
    return 0, 2 * x.shape[0] * w_q.shape[0] * w_q.shape[1], cost.nbytes(
        x, w_q, rest, tuple(kw.values()), out)


@cost.boundary(_count)
def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8, x_scale (M,) f32, w_scale (N,) f32
    -> (M, N) bf16. A CPU tensor takes the plain version; CUDA tensors must
    be contiguous and on one device."""
    if build.runs_plain(x_q):
        return ref.int8_matmul_ref(x_q, w_q, x_scale, w_scale)
    dev = x_q.device
    build.check("int8_matmul x_q", x_q, torch.int8, 2, dev)
    build.check("int8_matmul x_scale", x_scale, torch.float32, 1, dev)
    m, k = x_q.shape
    n = _check_weights("int8_matmul", w_q, w_scale, dev, k)
    if x_scale.shape[0] != m:
        raise ValueError(f"int8_matmul: x_q {tuple(x_q.shape)} with scales "
                         f"{tuple(x_scale.shape)}")
    if not (x_q.is_contiguous() and x_scale.is_contiguous()):
        raise ValueError("int8_matmul: inputs must be contiguous")
    build.check_int32("int8_matmul", m, n, k)
    plan = gemm_plan(m, n, k, w_q.data_ptr(), x_q.data_ptr())
    ws = _workspace(dev, plan)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    KERNEL.launch(x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                  w_scale.data_ptr(), out.data_ptr(),
                  0 if ws is None else ws.data_ptr(),
                  0 if ws is None else ws.numel(), m, n, k,
                  plan.ksteps, plan.split, plan.vec, plan.x_vec, plan.smem,
                  stream=build.stream_of(x_q))
    return out


@cost.boundary(_count)
def int8_matmul_quant(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      out_q: Optional[torch.Tensor] = None,
                      out_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) float -> (M, N) bf16: x quantized per row (``quantize_ref``,
    B2's codes and scales), then the W8A8 product with w_q (K, N) int8 and
    w_scale (N,) f32, in one launch. ``out_q`` (M, K) int8 and ``out_s``
    (M,) f32, if given, receive the codes and scales (for checks; the
    serving path passes neither). A CPU tensor takes the plain version; a
    CUDA x must be contiguous bf16."""
    if build.runs_plain(x):
        x_q, x_s = ref.quantize_ref(x)
        for dst, src in ((out_q, x_q), (out_s, x_s)):
            if dst is not None:
                dst.copy_(src)
        return ref.int8_matmul_ref(x_q, w_q, x_s, w_scale)
    dev = x.device
    build.check("int8_matmul_quant x", x, torch.bfloat16, 2, dev)
    m, k = x.shape
    n = _check_weights("int8_matmul_quant", w_q, w_scale, dev, k)
    if not x.is_contiguous():
        raise ValueError("int8_matmul_quant: inputs must be contiguous")
    for name, t, dtype, shape in (("out_q", out_q, torch.int8, (m, k)),
                                  ("out_s", out_s, torch.float32, (m,))):
        if t is not None:
            build.check(f"int8_matmul_quant {name}", t, dtype, len(shape),
                        dev)
            if t.shape != shape or not t.is_contiguous():
                raise ValueError(f"int8_matmul_quant: {name} must be a "
                                 f"contiguous {shape} tensor")
    build.check_int32("int8_matmul_quant", m, n, k)
    plan = gemm_plan(m, n, k, w_q.data_ptr(), x.data_ptr(), x_bytes=2)
    ws = _workspace(dev, plan)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    QUANT_KERNEL.launch(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                        out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                        0 if ws is None else ws.numel(),
                        0 if out_q is None else out_q.data_ptr(),
                        0 if out_s is None else out_s.data_ptr(), m, n, k,
                        plan.ksteps, plan.split, plan.vec, plan.x_vec,
                        plan.smem, stream=build.stream_of(x))
    return out
