"""Structure sensitivity from the diagonal Fisher approximation (§II-B).

    S_g = (1/|D_calib|) Σ_i || ∂L(W, x_i, y_i)/∂W_g ||²

One backward pass per calibration batch accumulates squared gradients (the
diagonal FIM estimate); a structural unit's sensitivity is the sum of that
diagonal over the unit's parameter slices. The LM's units are the KV heads
(with their query heads), the Mamba channels, the mLSTM heads, and the FFN
columns or the experts of every layer; the CNNs' are conv channels
(``cnn_prune_groups``).

Member encoding
---------------
A *member* is (path, axis, block, offset): the leaf at ``path`` holds
``size`` units along ``axis``, unit ``u`` occupying rows/cols
``[offset + u*block, offset + (u+1)*block)``. The JAX package addresses
layer ``g`` of its stacked layout as ``("__stack__", g, "blocks", 0, ...)``;
the port's ``blocks`` is a list of per-layer dicts, so the same member is
``("blocks", g, ...)``, with the same axes (those of one layer's leaf).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterable, List, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.roofline import cost

Member = Tuple[Tuple, int, int, int]     # (path, axis, block, offset)


# ------------------------------------------------------------------ FIM diag
def fisher_diag(grad_fn: Callable[[Any, Any], Any], params: Any,
                calib_batches: Iterable[Any]) -> Tuple[Any, int]:
    """E[g²] over the calibration set, f32. ``grad_fn(params, batch)`` ->
    a gradient tree shaped like ``params``."""
    acc = None
    n = 0
    for batch in calib_batches:
        sq = tree.map_(lambda t: t.float().square(), grad_fn(params, batch))
        acc = sq if acc is None else tree.map_(torch.add, acc, sq)
        n += 1
    if n == 0:
        raise ValueError("empty calibration set")
    return tree.map_(lambda t: t / n, acc), n


def _grad(value: torch.Tensor, live: List[torch.Tensor]) -> tuple:
    """``torch.autograd.grad(value, live)``. On the meta device (the dry
    run) a pass runs some of its layers for all of them
    (``lm.layer_order``), so a leaf may be unused: its gradient is zeros,
    made uncounted."""
    if live[0].device.type != "meta":
        return torch.autograd.grad(value, live)
    grads = torch.autograd.grad(value, live, allow_unused=True)
    with cost.suspended():
        return tuple(torch.zeros_like(t) if g is None else g
                     for g, t in zip(grads, live))


def value_and_grad(loss: Callable[[Any, Any], Any], has_aux: bool = False
                   ) -> Callable[[Any, Any], Tuple[Any, Any]]:
    """``fn(params, batch)`` -> (the scalar ``loss(params, batch)``
    detached, its gradient with respect to every leaf of ``params`` as a
    tree shaped like ``params``), by ``torch.autograd.grad``. With
    ``has_aux`` the loss returns (scalar, dict of tensors) and the first
    element is that pair, detached, as ``jax.value_and_grad``'s. The params
    are not modified, and the autograd graph is freed when the gradients
    are returned."""
    def fn(params, batch):
        leaves = tree.leaves(params)
        live = [t.detach().requires_grad_(True) for t in leaves]
        it = iter(live)
        with torch.enable_grad():
            out = loss(tree.map_(lambda _: next(it), params), batch)
            value = out[0] if has_aux else out
            grads = _grad(value, live)
        it = iter(grads)
        grads = tree.map_(lambda _: next(it), params)
        if has_aux:
            return (value.detach(),
                    {k: v.detach() for k, v in out[1].items()}), grads
        return value.detach(), grads
    return fn


def loss_grad_fn(loss: Callable[[Any, Any], torch.Tensor]
                 ) -> Callable[[Any, Any], Any]:
    """``grad_fn`` for ``fisher_diag``: the gradient tree of
    ``value_and_grad(loss)``."""
    vg = value_and_grad(loss)
    return lambda params, batch: vg(params, batch)[1]


# ------------------------------------------------------------------ groups
@dataclasses.dataclass
class GroupSpec:
    name: str
    members_grad: List[Member]   # leaves contributing to S
    members_all: List[Member]    # every leaf to zero/remove on pruning
    size: int                    # number of units (channels/heads/experts)
    kind: str = "channel"


def m(path, axis, block=1, offset=0) -> Member:
    return (tuple(path), axis, block, offset)


def _get(params, path):
    for p in path:
        params = params[p]
    return params


def _set(params, path, value):
    """A copy of ``params`` with the leaf at ``path`` replaced: the dicts
    and lists along the path are copied, every other node is shared."""
    key = path[0]
    sub = value if len(path) == 1 else _set(params[key], path[1:], value)
    if isinstance(params, (list, tuple)):
        out = list(params)
        out[key] = sub
        return type(params)(out)
    return {**params, key: sub}


def group_sensitivity(sq_grads: Any, spec: GroupSpec) -> torch.Tensor:
    """S per unit (size,) f32: the sum of E[g²] over each unit's slices
    across the members. Summed in f64, so the result is the correctly
    rounded f32 of the sum whatever the device."""
    s = None
    for path, axis, block, offset in spec.members_grad:
        leaf = torch.movedim(_get(sq_grads, path), axis, 0)
        sl = leaf[offset:offset + spec.size * block]
        part = sl.double().reshape(spec.size, -1).sum(-1)
        s = part if s is None else s + part
    return s.float()


def _axis_mask(keep: torch.Tensor, length: int, block: int,
               offset: int) -> torch.Tensor:
    vec = torch.ones((length,), dtype=torch.float32, device=keep.device)
    vec[offset:offset + keep.numel() * block] = torch.repeat_interleave(
        keep.float(), block)
    return vec


def mask_group(params: Any, spec: GroupSpec, drop: torch.Tensor) -> Any:
    """Zero the units selected by boolean ``drop`` (size,). Shape-preserving;
    ``params`` is not modified."""
    keep = ~drop
    for path, axis, block, offset in spec.members_all:
        leaf = _get(params, path)
        vec = _axis_mask(keep.to(leaf.device), leaf.shape[axis], block,
                         offset)
        shape = [1] * leaf.ndim
        shape[axis] = leaf.shape[axis]
        params = _set(params, path,
                      leaf * vec.reshape(shape).to(leaf.dtype))
    return params


def compact_group(params: Any, spec: GroupSpec,
                  keep_units: np.ndarray) -> Any:
    """Physically remove the units not in ``keep_units`` (the deployment
    artifact). Members sharing a (leaf, axis) are compacted in ONE gather,
    since removing the first member's slices would shift the second
    member's offsets."""
    by_leaf = {}
    for path, axis, block, offset in spec.members_all:
        by_leaf.setdefault((tuple(path), axis), []).append((block, offset))
    drop_units = np.setdiff1d(np.arange(spec.size), keep_units)
    for (path, axis), members in by_leaf.items():
        leaf = _get(params, path)
        keep_mask = np.ones(leaf.shape[axis], bool)
        for block, offset in members:
            idx = (offset + drop_units[:, None] * block
                   + np.arange(block)[None, :]).reshape(-1)
            keep_mask[idx] = False
        index = torch.as_tensor(np.nonzero(keep_mask)[0], device=leaf.device)
        params = _set(params, path,
                      torch.index_select(leaf, axis, index).contiguous())
    return params


# ------------------------------------------------------------------ CNN specs
def cnn_prune_groups(cfg, variables: dict) -> List[GroupSpec]:
    """Prunable channel families of the paper's two architectures, the JAX
    package's specs exactly (names, members, order, sizes).

    ResNet-18: the conv1 (intra-block) channels of every basic block; the
    residual-identity path is never pruned (§V-D alignment discussion).
    MobileNetV3-S: the expansion channels of every inverted bottleneck (the
    family the paper found highest-sparsity, §V-C), with the SE convs and
    the BN statistics among the members removed with them.
    """
    p = variables["params"]
    groups: List[GroupSpec] = []
    if cfg.arch == "resnet18":
        for name in sorted(k for k in p if re.match(r"^s\d+b\d+$", k)):
            c = p[name]["conv1"].shape[3]
            mg = [m(("params", name, "conv1"), 3),
                  m(("params", name, "conv2"), 2),
                  m(("params", name, "bn1", "scale"), 0)]
            ma = mg + [m(("params", name, "bn1", "bias"), 0),
                       m(("stats", name, "bn1", "mean"), 0),
                       m(("stats", name, "bn1", "var"), 0)]
            groups.append(GroupSpec(f"{name}/conv1", mg, ma, c))
    else:  # mobilenetv3s
        for name in sorted((k for k in p if re.match(r"^b\d+$", k)
                            and isinstance(p[k], dict) and "expand" in p[k]),
                           key=lambda s: int(s[1:])):
            blk = p[name]
            c = blk["expand"].shape[3]
            mg = [m(("params", name, "expand"), 3),
                  m(("params", name, "dw"), 3),
                  m(("params", name, "project"), 2),
                  m(("params", name, "bn_e", "scale"), 0),
                  m(("params", name, "bn_d", "scale"), 0)]
            ma = list(mg) + [m(("params", name, "bn_e", "bias"), 0),
                             m(("params", name, "bn_d", "bias"), 0),
                             m(("stats", name, "bn_e", "mean"), 0),
                             m(("stats", name, "bn_e", "var"), 0),
                             m(("stats", name, "bn_d", "mean"), 0),
                             m(("stats", name, "bn_d", "var"), 0)]
            if "se_down" in blk:
                ma += [m(("params", name, "se_down", "w"), 2),
                       m(("params", name, "se_up", "w"), 3),
                       m(("params", name, "se_up", "b"), 0)]
            groups.append(GroupSpec(f"{name}/expand", mg, ma, c))
    return groups


# ------------------------------------------------------------------ LM specs
def lm_prune_groups(cfg) -> List[GroupSpec]:
    """Structural families of the LM, one per (layer, kind), in the JAX
    package's order, names and sizes: the period position outer, the group
    inner (layer ``g·P + j``, as the JAX package stacks it), and within a
    layer ``L{i}/kv_heads`` on an attention layer (a KV head with its G
    query heads: blocks of G·hd columns of wq and rows of wo, hd columns of
    wk and wv); on a dense layer ``L{i}/ffn`` (one column of gate and up,
    one row of down); on an MoE layer ``L{i}/experts`` (one expert's gate,
    up and down along axis 0, with its router column and its router bias;
    arctic's residual MLP is not pruned); on a Mamba layer
    ``L{i}/mamba_cols`` (one inner channel: a row of x_proj and out_proj
    and a column of dt_proj carry its sensitivity; its dt bias, conv
    column, a_log row, skip, and its columns in both halves of in_proj go
    with it); on an mLSTM layer ``L{i}/mlstm_heads`` (one head: its
    (hd, hd) block of wq, wk and wv carries its sensitivity; its gates'
    columns and biases, its hd rows of the gates, its hd columns in both
    halves of in_proj, its hd norm scales and out_proj rows go with it;
    the head width stays, the head count shrinks). sLSTM layers are not
    pruned (their gates' recurrence is nonlinear), as the JAX package's
    are not. The JAX package leaves the router bias out of the expert
    family, so its ``compact_params`` keeps the bias at full width while
    the router's columns shrink (ROADMAP C7); here the bias is compacted
    with them, and the compacted model computes what the masked model
    computes. Masks are per layer, so the conditional loop can give the
    paper's non-uniform layer-wise sparsity."""
    from repro_torch.models.lm import layer_specs, pattern_period
    period = pattern_period(cfg)
    spec = layer_specs(cfg)[:period]
    hd = cfg.resolved_head_dim
    g_ratio = cfg.n_heads // cfg.n_kv_heads
    out: List[GroupSpec] = []
    for j, (kind, is_moe) in enumerate(spec):
        for i in range(j, cfg.n_layers, period):
            st = ("blocks", i)
            if kind == "attn":
                mm = [m(st + ("attn", "wq", "w"), 1, g_ratio * hd),
                      m(st + ("attn", "wk", "w"), 1, hd),
                      m(st + ("attn", "wv", "w"), 1, hd),
                      m(st + ("attn", "wo", "w"), 0, g_ratio * hd)]
                out.append(GroupSpec(f"L{i}/kv_heads", mm, list(mm),
                                     cfg.n_kv_heads, kind="kv_head"))
            if kind in ("attn", "mamba") and cfg.d_ff > 0 and not is_moe:
                mm = [m(st + ("mlp", "gate", "w"), 1),
                      m(st + ("mlp", "up", "w"), 1),
                      m(st + ("mlp", "down", "w"), 0)]
                out.append(GroupSpec(f"L{i}/ffn", mm, list(mm), cfg.d_ff,
                                     kind="ffn_col"))
            if is_moe:
                mm = [m(st + ("moe", "gate", "w"), 0),
                      m(st + ("moe", "up", "w"), 0),
                      m(st + ("moe", "down", "w"), 0)]
                out.append(GroupSpec(
                    f"L{i}/experts", mm,
                    mm + [m(st + ("moe", "router", "w"), 1),
                          m(st + ("moe", "router", "b"), 0)],
                    cfg.moe.n_experts, kind="expert"))
            if kind == "mamba":
                d_in = cfg.ssm.expand * cfg.d_model
                mb = st + ("mamba",)
                mm = [m(mb + ("x_proj", "w"), 0),
                      m(mb + ("out_proj", "w"), 0),
                      m(mb + ("dt_proj", "w"), 1)]
                ma = mm + [m(mb + ("dt_proj", "b"), 0),
                           m(mb + ("conv_w",), 1),
                           m(mb + ("a_log",), 0),
                           m(mb + ("d_skip",), 0),
                           m(mb + ("in_proj", "w"), 1, 1, 0),
                           m(mb + ("in_proj", "w"), 1, 1, d_in)]
                out.append(GroupSpec(f"L{i}/mamba_cols", mm, ma, d_in,
                                     kind="mamba_col"))
            if kind == "mlstm":
                d_in = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
                head_d = d_in // cfg.n_heads
                ml = st + ("mlstm",)
                mm = [m(ml + ("wq",), 0), m(ml + ("wk",), 0),
                      m(ml + ("wv",), 0)]
                ma = mm + [m(ml + ("w_i", "w"), 1),
                           m(ml + ("w_i", "b"), 0),
                           m(ml + ("w_f", "w"), 1),
                           m(ml + ("w_f", "b"), 0),
                           m(ml + ("w_i", "w"), 0, head_d),
                           m(ml + ("w_f", "w"), 0, head_d),
                           m(ml + ("in_proj", "w"), 1, head_d, 0),
                           m(ml + ("in_proj", "w"), 1, head_d, d_in),
                           m(ml + ("norm", "g"), 0, head_d),
                           m(ml + ("out_proj", "w"), 0, head_d)]
                out.append(GroupSpec(f"L{i}/mlstm_heads", mm, ma,
                                     cfg.n_heads, kind="mlstm_head"))
    return out
