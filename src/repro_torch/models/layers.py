"""Shared building blocks: norms, rotary embeddings, (possibly quantized)
dense, embed/unembed, silu and the other gates' functions, SwiGLU.

A linear's params are either ``{"w": (in, out) bf16}`` or a
``QuantizedLinear``; ``dense`` dispatches on the type, so the same model code
serves the FP model and the INT8 artifact.

Batch invariance. The serving engine must give the same bits as serial
decode, so a row's result may not depend on how many rows share the call.
Elementwise ops and the INT8 kernels have that property by construction.
Two kinds of op do not on the card: PyTorch's CUDA reductions pick their
thread split, and so their summation order, from the number of rows, and
cuBLAS may pick another algorithm for another M. So the norms sum squares
with ``row_sum`` (a fixed pairwise tree of elementwise adds), and the bf16
products (``unembed`` and the FP ``dense``) go through ``matmul_rows``, one
row at a time.

The train route (``lm.forward``, ``lm.loss_fn``) has no such contract, and
autograd through ``matmul_rows`` would cost a launch per row per projection
in both directions, so it passes ``batch_invariant=False``: one
``torch.matmul`` per product and a plain sum in the norms."""
from __future__ import annotations

import math

import torch

from repro_torch.compress.qtypes import (QuantizedLinear, linear_kernel,
                                         out_features)
from repro_torch.kernels import ops
from repro_torch.roofline import cost

# re-exported for model code that types against the layers namespace
__all__ = ["QuantizedLinear", "linear_kernel", "out_features"]

COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------- init utils
def he_init(gen: torch.Generator, shape, dtype=torch.float32
            ) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device)
            * (2.0 / shape[0]) ** 0.5).to(dtype)


def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                dtype=COMPUTE_DTYPE) -> dict:
    return {"w": he_init(gen, (d_in, d_out), dtype)}


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=COMPUTE_DTYPE) -> dict:
    return {"table": (torch.randn((vocab, d), generator=gen,
                                  device=gen.device) * 0.02).to(dtype)}


def rmsnorm_init(d: int, device) -> dict:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------- batch invariance
def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (keepdim) in a fixed pairwise order: the
    order of every add is the same for every row, on every device, whatever
    the number of rows. Zero padding to a power of two adds exact zeros."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) in the dtype of the inputs, one row at a time, so
    each row's bits are those of a one-row product whatever the batch."""
    n = math.prod(x.shape[:-1])
    x2 = x.reshape(n, x.shape[-1])
    out = cost.catted([x2[i:i + 1] @ w for i in cost.loop(n, x2)], n)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def matmul(x: torch.Tensor, w: torch.Tensor,
           batch_invariant: bool) -> torch.Tensor:
    return matmul_rows(x, w) if batch_invariant else x @ w


def sum_last(x: torch.Tensor, batch_invariant: bool) -> torch.Tensor:
    return row_sum(x) if batch_invariant else x.sum(-1, keepdim=True)


# ---------------------------------------------------------------- dense
def dense(x: torch.Tensor, p, batch_invariant: bool = True) -> torch.Tensor:
    """FP weight dict, or a ``QuantizedLinear`` (W8A8: the activations are
    quantized per row and the dequant runs in the matmul epilogue). An
    empty linear (HQP cut its family to nothing, ROADMAP C11) gives zeros
    and launches nothing."""
    if isinstance(p, QuantizedLinear):
        if p.w_q.numel() == 0:
            return x.new_zeros((*x.shape[:-1], p.w_q.shape[-1]),
                               dtype=COMPUTE_DTYPE)
        return ops.int8_matmul(x, p.w_q, p.scale)
    return matmul(x.to(COMPUTE_DTYPE), p["w"].to(COMPUTE_DTYPE),
                  batch_invariant)


# ---------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, p: dict, eps: float = 1e-5,
            batch_invariant: bool = True) -> torch.Tensor:
    xf = x.float()
    var = sum_last(xf * xf, batch_invariant) / xf.shape[-1]
    return (xf * torch.rsqrt(var + eps) * p["g"]).to(COMPUTE_DTYPE)


def l2norm(x: torch.Tensor, eps: float = 1e-6,
           batch_invariant: bool = True) -> torch.Tensor:
    """Per-head qk-norm (qwen3 style), no learned scale."""
    xf = x.float()
    var = sum_last(xf * xf, batch_invariant) / xf.shape[-1]
    return (xf * torch.rsqrt(var + eps)).to(COMPUTE_DTYPE)


# ---------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int. Computed in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------- embedding
def embed_lookup(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens].to(COMPUTE_DTYPE)


def unembed(p: dict, x: torch.Tensor,
            batch_invariant: bool = True) -> torch.Tensor:
    """Logits in f32 (from the bf16 product, as the reference)."""
    return matmul(x.to(COMPUTE_DTYPE), p["table"].to(COMPUTE_DTYPE).t(),
                  batch_invariant).float()


# ---------------------------------------------------------------- MLP (SwiGLU)
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {"gate": linear_init(gen, d_model, d_ff),
            "up": linear_init(gen, d_model, d_ff),
            "down": linear_init(gen, d_ff, d_model)}


def _exp(x: torch.Tensor):
    """(exp(x), the entries where it overflowed to inf, or None outside
    autograd). Under autograd those entries' exp takes 0 instead of x: an
    inf in the graph makes its backward 0·inf = NaN where the derivative of
    the saturated function built on it is 0 (ROADMAP C14), and the caller
    sets their value. Elsewhere the same ops, so the same bits, forward
    and backward."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.exp(x), None
    with torch.no_grad():
        over = torch.isinf(torch.exp(x))
    return torch.exp(torch.where(over, 0.0, x)), over


def _saturate(r: torch.Tensor, over, value: float) -> torch.Tensor:
    return r if over is None else torch.where(over, value, r)


def silu(a: torch.Tensor) -> torch.Tensor:
    """silu(a) = a * (1 / (1 + exp(-a))), rounded to a's dtype after every
    op (bf16: as the reference's compiled program computes it). Built
    from ``exp``, whose CPU kernel rounds every element alike whatever the
    shape (``torch.nn.functional.silu``'s does not); its gradient is 0
    where exp(-a) overflows, as ``jax.nn.silu``'s (``_exp``)."""
    e, over = _exp(-a)
    return a * _saturate(1.0 / (1.0 + e), over, 0.0)


def sigmoid(a: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-a)), from ``exp`` as ``silu``."""
    e, over = _exp(-a)
    return _saturate(1.0 / (1.0 + e), over, 0.0)


def tanh(a: torch.Tensor) -> torch.Tensor:
    """2 / (1 + exp(-2a)) - 1, from ``exp`` as ``silu`` (within an f32 ulp
    of 1 of the true tanh, and ±1 exactly where exp overflows)."""
    e, over = _exp(-2.0 * a)
    return _saturate(2.0 / (1.0 + e), over, 0.0) - 1.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's ``jax.nn.softplus`` (logaddexp(x,
    0)) forms it: max(x, 0) + log(1 + e^-|x|), from ``exp`` and ``log``
    (PyTorch's own softplus and log1p round a vector loop's tail apart
    from its body on the CPU)."""
    return torch.clamp_min(x, 0) + torch.log(1 + torch.exp(-x.abs()))


def mlp(x: torch.Tensor, p: dict, batch_invariant: bool = True
        ) -> torch.Tensor:
    """SwiGLU in bf16 (``silu``)."""
    a = dense(x, p["gate"], batch_invariant)
    return dense(silu(a) * dense(x, p["up"], batch_invariant), p["down"],
                 batch_invariant)
