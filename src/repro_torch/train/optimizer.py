"""AdamW with f32 or INT8 first and second moments (the JAX package's
``train/optimizer.py``).

The INT8 state keeps each moment in the param's shape with one f32 scale
per row of the last axis (the reference's ``_block_dim`` returns the whole
last axis); the second moment is stored as sqrt(v), which keeps small
entries' resolution. Codes divide by 127 with a true division, as the
reference computes when it runs eagerly (ROADMAP C1: under ``jit`` XLA may
multiply by fl(1/127) instead).

The state is ``{"step": int32 0-d, "m": tree, "v": tree}``, the trees shaped
like the params, their leaves f32 tensors or ``{"q": int8, "s": f32}``."""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import tree
from repro_torch.roofline import cost


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    state_dtype: str = "f32"         # "f32" | "int8"
    grad_clip: float = 1.0


# ---------------------------------------------------------- int8 state codec
def _rows(shape) -> Tuple[int, ...]:
    return tuple(shape) or (1,)


def _encode(x: torch.Tensor, sqrt_map: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (param shape) -> (int8 codes of that shape, f32 scales
    (..., 1): absmax / 127 per row of the last axis). ``sqrt_map`` encodes
    sqrt(x) of the non-negative second moment."""
    if sqrt_map:
        x = torch.sqrt(torch.clamp_min(x, 0.0))
    shape = _rows(x.shape)
    g = x.reshape(*shape[:-1], 1, shape[-1])
    amax = g.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.reshape(shape), scale[..., 0]


def _decode(q: torch.Tensor, scale: torch.Tensor, shape,
            sqrt_map: bool = False) -> torch.Tensor:
    shape = _rows(shape)
    g = q.reshape(*shape[:-1], 1, shape[-1]).float()
    out = (g * scale[..., None]).reshape(shape)
    return out.square() if sqrt_map else out


# ---------------------------------------------------------------- init/update
def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like ``params``, on their device."""
    def zero_state(p):
        if cfg.state_dtype == "int8":
            shape = _rows(p.shape)
            return {"q": torch.zeros(shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.zeros((*shape[:-1], 1), dtype=torch.float32,
                                     device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree.leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree.map_(zero_state, params),
            "v": tree.map_(zero_state, params)}


def _global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float().square())
                          for g in tree.leaves(grads)))


def _decayed(params: Any) -> Any:
    """A tree of bools shaped like ``params``: the leaves of two or more
    dimensions in the JAX package's layout, where each ``blocks`` list
    stacks its layers along a new axis 0. A layer's 1-D leaves (norm gains,
    the router bias, Mamba's ``d_skip`` and ``conv_b``, the xLSTM gate
    biases) are 2-D there, and decay."""
    def walk(node, stacked):
        if isinstance(node, dict):
            return {k: walk(v, stacked or k == "blocks")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, stacked) for v in node)
        return node.ndim + stacked >= 2
    return walk(params, False)


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig
                 ) -> Tuple[Any, dict]:
    """One AdamW step -> (new params, new state); the inputs are not
    modified. The gradients are clipped to a global norm of
    ``cfg.grad_clip``; weight decay applies to params of two or more
    dimensions in the reference's stacked layout (``_decayed``); the new
    param is computed in f32 and cast back to the param's dtype."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    int8 = cfg.state_dtype == "int8"

    def upd(p, g, m, v, decay):
        g = g.float() * clip
        if int8:
            mf = _decode(m["q"], m["s"], p.shape)
            vf = _decode(v["q"], v["s"], p.shape, sqrt_map=True)
        else:
            mf, vf = m, v
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g.square()
        upd_val = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if decay:
            upd_val = upd_val + cfg.weight_decay * p.float()
        new_p = (p.float() - cfg.lr * upd_val).to(p.dtype)
        if int8:
            mq, ms = _encode(mf)
            vq, vs = _encode(vf, sqrt_map=True)
            return new_p, {"q": mq, "s": ms}, {"q": vq, "s": vs}
        return new_p, mf, vf

    if tree.leaves(params)[0].device.type == "meta":
        # the dry run: layers of one shape update alike
        upd = cost.repeats(upd, lambda p, g, m, v, decay: (
            tuple(p.shape), p.dtype, decay))
    out = tree.map_(upd, params, grads, state["m"], state["v"],
                    _decayed(params))
    part = lambda i: tree.map_(lambda _, o: o[i], params, out)
    return part(0), {"step": step, "m": part(1), "v": part(2)}
