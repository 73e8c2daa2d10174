"""Causal flash attention of the train route: the wrapper of
``csrc/flash_attention.cu`` (replaces ``flash_attention_pallas``, B7) and
its gradient.

``flash_attention`` is differentiable. On a CUDA tensor its forward is the
kernel, which also writes the f32 log-sum-exp of every row, and its backward
is ``flash_attention_backward``: the exact attention gradient in PyTorch
tensor ops, blockwise over query rows, from the saved q, k, v, output and
log-sum-exp. That backward is not the plain version of B7. The JAX package
has no backward kernel: its gradient is XLA's autodiff of the jnp train
route (``models/attention.py``), and this is its counterpart. A CPU tensor
takes the plain version, ``ref.flash_attention_ref``, and autograd runs
through its tensor ops."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import cost

KERNEL = build.Kernel("flash_attention", "flash_attention",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_longlong] * 9 + [ctypes.c_float])

G_MAX = 64                  # query heads per kv head: a block's 64 rows
HEAD_DIMS = (16, 64, 96, 128)   # the kernel's instances (smoke, repo,
                                # phi-3-vision, Qwen3)
BACKWARD_BLOCK_Q = 512      # query rows per block of the backward
ROWS = 64                   # a block's rows, as in csrc/flash_attention.cu


@dataclass(frozen=True)
class FlashPlan:
    queries: int        # queries a block takes (its rows are their G heads)
    grid: Tuple[int, int, int]      # (Hkv, query tiles, B)


def flash_plan(b: int, s: int, hq: int, hkv: int) -> FlashPlan:
    """The kernel's grid, which the kernel forms the same way: blocks of
    the G = hq / hkv query heads of floor(64 / G) queries, one per (kv head,
    query tile, batch)."""
    bq = ROWS // (hq // hkv)
    return FlashPlan(queries=bq, grid=(hkv, -(-s // bq), b))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: q (B, S, Hq, hd), k and v (B, S, Hkv, hd), bf16 on
    one CUDA device, hd in HEAD_DIMS, the last dim contiguous and the other
    strides multiples of 8 elements from a 16-byte aligned start (the
    kernel copies 16 bytes at a time) -> (out (B, S, Hq, hd) bf16, lse
    (B, Hq, S) f32)."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check(f"flash_attention {name}", t, torch.bfloat16, 4, dev)
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous")
        if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name}'s strides "
                             f"{t.stride()} must be multiples of 8 elements "
                             f"from a 16-byte aligned start")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if (k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd
            or hkv < 1 or hq % hkv or hq // hkv > G_MAX):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    build.check_int32("flash_attention", b * s * hq * hd)
    if max(flash_plan(b, s, hq, hkv).grid) > 65535:
        raise ValueError(f"flash_attention: grid over 65535 for q "
                         f"{tuple(q.shape)}")
    out = torch.empty((b, s, hq, hd), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), b, s, hkv, hq // hkv, hd,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  float(hd ** -0.5), stream=build.stream_of(q))
    return out, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, d_out: torch.Tensor,
                             block_q: int = BACKWARD_BLOCK_Q
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of causal attention, in f32 and returned in the inputs'
    dtypes, from the forward's output and log-sum-exp (B, Hq, S). For each
    block of query rows: P = exp(s - lse) on the causal prefix, dV += Pᵀ·dO,
    dS = P∘(dO·Vᵀ − D)·scale with D = rowsum(dO∘O), dQ = dS·K, dK += dSᵀ·Q.
    The G query heads of a kv head share its K and V (query head h reads kv
    head h // G), so dK and dV sum over them, with no G-fold copy."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5

    def heads(t):               # (B, S, Hq, hd) -> (B, Hkv, G, S, hd) f32
        return t.float().reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)

    qf, of, dof = heads(q), heads(out), heads(d_out)
    kf = k.float().permute(0, 2, 1, 3)                   # (B, Hkv, S, hd)
    vf = v.float().permute(0, 2, 1, 3)
    lse = lse.float().reshape(b, hkv, g, s)
    dd = (dof * of).sum(-1)                              # D (B, Hkv, G, S)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, block_q):
        q1 = min(s, q0 + block_q)            # rows q0..q1-1 see kv < q1
        kk, vv = kf[:, :, :q1], vf[:, :, :q1]
        qb, dob = qf[..., q0:q1, :], dof[..., q0:q1, :]
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qb, kk) * scale
        mask = pos[None, :q1] <= pos[q0:q1, None]
        p = torch.where(mask, torch.exp(sc - lse[..., q0:q1, None]),
                        sc.new_zeros(()))
        dv[:, :, :q1] += torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vv)
        ds = p * (dp - dd[..., q0:q1, None]) * scale
        dq[..., q0:q1, :] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kk)
        dk[:, :, :q1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The kernel forward with the explicit backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        return flash_attention_backward(*ctx.saved_tensors, d_out)


def flash_counts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """(flops, INT8 flops, bytes) of causal attention over q (B, S, Hq,
    hd) and k, v (B, S, Hkv, hd), forward then backward, counted over the
    whole S x S score matrix as the JAX package's train route computes it:
    the forward's QK and PV, 4·B·S·S·Hq·hd, reading q, k, v and writing
    the output; the backward's four products (dQ, dK from dS; dP, dV from
    dO), twice the forward's, reading q, k, v, the output and its
    gradient and writing dq, dk, dv."""
    b, s, hq, hd = q.shape
    fwd = 4 * b * s * k.shape[1] * hq * hd
    io = cost.nbytes(q, k, v)
    return ((fwd, 0, io + cost.nbytes(q)),
            (2 * fwd, 0, 2 * io + 2 * cost.nbytes(q)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Causal attention, q (B, S, Hq, hd) against k, v (B, S, Hkv, hd) ->
    (B, S, Hq, hd) in q's dtype; query i sees positions <= i. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (bf16)."""
    if build.runs_plain(q):
        return ref.flash_attention_ref(q, k, v)
    return _FlashAttention.apply(q, k, v)
