"""Mamba (selective SSM) block, the port of the JAX package's
``models/ssm.py``.

Recurrence: h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t ;  y_t = C_t h_t + D x_t

The JAX package runs the train and prefill routes as a chunked associative
scan and decode as one sequential step: two forms that round differently,
and a chunked scan that needs the length to be a multiple of its chunk
(ROADMAP C9: a 40-token prompt at chunk 32 raises). Here every route
steps the one f32 recurrence in order, position by position, with the same
expression, and the causal depthwise conv sums its K taps in one fixed
order on every route. So a decode step, a prefill chunk and a whole prompt
give the same bits however the prompt is cut, and every length runs;
``SSMConfig.chunk`` is kept as a field and not read.

Batch invariance (``layers``): in_proj and out_proj go through ``dense``
(B1 per row when quantized, ``matmul_rows`` in bf16 otherwise), x_proj
through ``dense`` (the reference keeps it FP), dt_proj through
``matmul_rows`` in f32, and ``y = Σ_n h·C`` through ``row_sum``; the rest
is elementwise, and its transcendental functions are built from ``exp``
and ``log`` (``layers.softplus``, ``layers.silu``): on the CPU, PyTorch's own
softplus, silu and log1p round an element in a vectorized loop's tail apart
from the same element in its body, so a row's bits would depend on the
batch. The train route (``batch_invariant=False``) takes one product per
projection and a plain sum instead.

A decode state is ``{"h": (B, d_in, n) f32, "conv": (B, K-1, d_in) f32}``:
the recurrent state and the last K-1 conv inputs. ``mamba_forward``
returns a new state and never writes the one it was given, so a caller
decides where the new state is kept (``serving.state_pool``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.roofline import cost


def dt_rank(cfg) -> int:
    s = cfg.ssm
    return s.dt_rank or -(-cfg.d_model // 16)


def mamba_init(gen: torch.Generator, cfg) -> dict:
    """in_proj (d, 2·d_in), x_proj (d_in, r + 2n) and out_proj (d_in, d)
    in bf16; conv_w (K, d_in), dt_proj, a_log (d_in, n) and d_skip in
    f32, as the reference's."""
    s = cfg.ssm
    d, d_in = cfg.d_model, s.expand * cfg.d_model
    r = dt_rank(cfg)
    dev = gen.device
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=dev).repeat(d_in, 1)
    return {
        "in_proj": L.linear_init(gen, d, 2 * d_in),
        "conv_w": torch.randn((s.d_conv, d_in), generator=gen,
                              device=dev) * 0.1,
        "x_proj": L.linear_init(gen, d_in, r + 2 * s.d_state),
        "dt_proj": {"w": L.he_init(gen, (r, d_in), torch.float32),
                    "b": torch.full((d_in,), -4.6, dtype=torch.float32,
                                    device=dev)},      # softplus ≈ 0.01
        "a_log": torch.log(a),
        "d_skip": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": L.linear_init(gen, d_in, d),
    }


def init_mamba_state(batch: int, cfg, d_in: Optional[int] = None,
                     device=None) -> dict:
    """A zero state. ``d_in``: the channel width of an HQP-compacted
    block (its ``conv_w``'s)."""
    s = cfg.ssm
    if d_in is None:
        d_in = s.expand * cfg.d_model
    return {"h": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, d_in),
                                dtype=torch.float32, device=device)}


def causal_conv(xpad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xpad (B, K-1+S, C) f32, the K-1 inputs before the chunk then the
    chunk's; w (K, C) f32 -> the causal depthwise conv (B, S, C) f32, its
    taps summed in order 0..K-1 on every route."""
    k = w.shape[0]
    s = xpad.shape[1] - (k - 1)
    out = xpad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xpad[:, i:i + s] * w[i]
    return out


def ssm_params(p: dict, xc: torch.Tensor, cfg, batch_invariant: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xc (B, S, d_in) bf16, the conv's output -> the selective parameters
    dt (B, S, d_in), B and C (B, S, n), all f32."""
    n, r = cfg.ssm.d_state, dt_rank(cfg)
    proj = L.dense(xc, p["x_proj"], batch_invariant).float()
    dt_in, b, c = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = L.softplus(L.matmul(dt_in, p["dt_proj"]["w"], batch_invariant)
                  + p["dt_proj"]["b"])
    return dt, b, c


def scan(h: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
         batch_invariant: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence from ``h`` (B, d_in, n), stepped in order over the
    S positions of dt, x (B, S, d_in) and b, c (B, S, n), all f32; ``a``
    (d_in, n) = -exp(a_log). Returns (y (B, S, d_in) f32 before the skip,
    the last h)."""
    ys = []
    for t in cost.loop(dt.shape[1], dt):
        dt_t = dt[:, t, :, None]
        h = (torch.exp(dt_t * a) * h
             + dt_t * b[:, t, None, :] * x[:, t, :, None])
        ys.append(L.sum_last(h * c[:, t, None, :], batch_invariant)[..., 0])
    return cost.catted(ys, dt.shape[1], 1, stack=True), h


def mamba_forward(p: dict, cfg, x: torch.Tensor,
                  state: Optional[dict] = None,
                  batch_invariant: bool = True
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) bf16 -> (out (B, S, d) bf16, the new state, or None
    without ``state``: the train route, which starts from zero state)."""
    s = cfg.ssm
    d_in = p["conv_w"].shape[-1]                  # shape-derived (pruning)
    b_sz, _, _ = x.shape
    xz = L.dense(x, p["in_proj"], batch_invariant)
    xin, z = xz[..., :d_in], xz[..., d_in:]
    if state is None:
        zero = init_mamba_state(b_sz, cfg, d_in, device=x.device)
        conv0, h0 = zero["conv"], zero["h"]
    else:
        conv0, h0 = state["conv"], state["h"]
    xpad = torch.cat([conv0, xin.float()], 1)
    xc = L.silu(causal_conv(xpad, p["conv_w"])).to(L.COMPUTE_DTYPE)
    dt, bb, cc = ssm_params(p, xc, cfg, batch_invariant)
    xf = xc.float()
    y, h = scan(h0, -torch.exp(p["a_log"]), dt, bb, cc, xf, batch_invariant)
    y = y + p["d_skip"] * xf
    out = y.to(L.COMPUTE_DTYPE) * L.silu(z)
    new_state = (None if state is None else
                 {"h": h, "conv": xpad[:, xpad.shape[1] - (s.d_conv - 1):]})
    return L.dense(out, p["out_proj"], batch_invariant), new_state
