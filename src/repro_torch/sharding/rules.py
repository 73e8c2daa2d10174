"""Partition rules: the placement of every param, optimizer-state, batch and
decode-state tensor from its path (the JAX package's
``sharding/rules.py``).

Conventions:
  TP ("model"): attention heads (wq/wk/wv out, wo in), FFN hidden, experts
  (EP), vocab. FSDP (data axes): the other big axis of every matrix, and
  optimizer state. xLSTM blocks: FSDP only (4 heads < 16-way model axis).

Decode-state placement: KV caches shard batch over data and *sequence* over
model (flash-decoding style); for global_batch=1 (long_500k) the sequence
axis takes every mesh axis.

A spec is a tuple with one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of two or more names (the dim split over them, major
first), as a ``jax.sharding.PartitionSpec`` holds them. The JAX package
stacks the layers of each period position along a leading group axis
that is never sharded; the port keeps ``blocks`` as a per-layer list
(``weights``), so a port leaf at ``blocks/<layer>/...`` takes the JAX
package's spec with that axis dropped, and a decode-state leaf likewise.
``to_placements`` turns a spec into ``torch.distributed.tensor``
placements, one per mesh dim."""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.compress.qtypes import QuantizedLinear
from repro_torch.sharding.ctx import RunContext

Spec = Tuple


def _norm(spec) -> Spec:
    """A spec in the form ``PartitionSpec`` keeps: a one-name tuple is the
    name, an empty one None."""
    return tuple((e[0] if len(e) == 1 else (e or None))
                 if isinstance(e, tuple) else e for e in spec)


def _rules(ctx: RunContext):
    """(regex over the "/"-joined path, spec of the JAX package's leaf:
    stacked block leaves lead with their group axis, None)."""
    da = tuple(ctx.data_axes)
    mdl = ctx.model_axis
    if ctx.pure_dp:
        # no-TP architectures (xLSTM family): the model axis joins the FSDP
        # group; every former-TP placement collapses to None.
        da = da + (mdl,)
        mdl = None
    return [
        # embeddings: vocab x d
        (r"(embed|unembed)/table$", (mdl, da)),
        (r"frontend/w$", (da, mdl)),
        # attention
        (r"blocks/\d+/attn/w[qkv]/w$", (None, da, mdl)),
        (r"blocks/\d+/attn/w[qkv]/(w_q|scale)$", (None, da, mdl)),
        (r"blocks/\d+/attn/wo/w(_q)?$", (None, mdl, da)),
        (r"blocks/\d+/attn/wo/scale$", (None, da)),
        # dense mlp
        (r"blocks/\d+/mlp/(gate|up)/(w|w_q)$", (None, da, mdl)),
        (r"blocks/\d+/mlp/(gate|up)/scale$", (None, mdl)),
        (r"blocks/\d+/mlp/down/(w|w_q)$", (None, mdl, da)),
        (r"blocks/\d+/mlp/down/scale$", (None, da)),
        # MoE: experts over model (EP), FSDP on d
        (r"blocks/\d+/moe/(gate|up)/(w|w_q)$", (None, mdl, da, None)),
        (r"blocks/\d+/moe/down/(w|w_q)$", (None, mdl, None, da)),
        (r"blocks/\d+/moe/(gate|up|down)/scale$", (None, mdl, None)),
        (r"blocks/\d+/moe/router/w$", (None, da, None)),
        (r"blocks/\d+/moe/router/b$", (None, None)),
        # mamba: d_inner over model
        (r"blocks/\d+/mamba/in_proj/(w|w_q)$", (None, da, mdl)),
        (r"blocks/\d+/mamba/in_proj/scale$", (None, mdl)),
        (r"blocks/\d+/mamba/conv_w$", (None, None, mdl)),
        (r"blocks/\d+/mamba/x_proj/w$", (None, mdl, None)),
        (r"blocks/\d+/mamba/dt_proj/w$", (None, None, mdl)),
        (r"blocks/\d+/mamba/dt_proj/b$", (None, mdl)),
        (r"blocks/\d+/mamba/a_log$", (None, mdl, None)),
        (r"blocks/\d+/mamba/d_skip$", (None, mdl)),
        (r"blocks/\d+/mamba/out_proj/(w|w_q)$", (None, mdl, da)),
        (r"blocks/\d+/mamba/out_proj/scale$", (None, da)),
        # xLSTM: FSDP only (heads < model-axis width)
        (r"blocks/\d+/(mlstm|slstm)/(in_proj|up|down|out_proj)/(w|w_q)$",
         (None, da, None)),
        (r"blocks/\d+/(mlstm|slstm)/w[zifo]$", (None, da, None)),
        # sLSTM recurrent mats stay replicated: they are consumed inside the
        # per-timestep recurrence, where an FSDP gather would run a step
        # at a time. mLSTM head mats are consumed once a chunk: FSDP.
        (r"blocks/\d+/mlstm/w[qkv]$", (None, None, da, None)),
    ]


def _axis_size(ctx: RunContext, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(ctx.mesh.shape[a] for a in axes)


def _divisible(shape, spec, ctx) -> bool:
    return all(dim % _axis_size(ctx, ax) == 0
               for dim, ax in zip(shape, spec))


def _stacked(path: str) -> bool:
    return re.match(r"blocks/\d+/", path) is not None


def spec_for_path(path: str, ndim: int, shape: Tuple[int, ...],
                  ctx: RunContext) -> Spec:
    """The spec of the port's leaf at ``path``: the JAX package's rule on
    the leaf as it stacks it (a block leaf with a leading group axis), that
    axis dropped. A rule applies only where its rank matches and every
    sharded dim divides by its axes' size; else the leaf is replicated."""
    lead = 1 if _stacked(path) else 0
    ndim, shape = ndim + lead, (1,) * lead + tuple(shape)
    spec = (None,) * ndim
    for pat, rule in _rules(ctx):
        if re.search(pat, path):
            if len(rule) == ndim and _divisible(shape, rule, ctx):
                spec = rule
            break
    return _norm(spec[lead:])


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every tensor of a port tree: dict keys, list
    indices and a ``QuantizedLinear``'s ``w_q`` and ``scale`` joined by
    "/", the key strings the JAX package's ``path_str`` gives."""
    if isinstance(tree, QuantizedLinear):
        yield f"{prefix}w_q", tree.w_q
        yield f"{prefix}scale", tree.scale
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def path_str(parts) -> str:
    """"/"-joined tree path, as the JAX package's ``path_str``."""
    return "/".join(str(p) for p in parts)


def param_specs(params: Any, ctx: RunContext) -> Dict[str, Spec]:
    """{path: spec} of every leaf of ``params``."""
    return {path: spec_for_path(path, leaf.dim(), tuple(leaf.shape), ctx)
            for path, leaf in named_leaves(params)}


# ------------------------------------------------------------------ states
def opt_state_specs(params: Any, opt_state: Any,
                    ctx: RunContext) -> Dict[str, Any]:
    """Optimizer-state specs mirror the param spec exactly: f32 moments
    take it verbatim; the INT8 codec's q is param-shaped (same spec) and
    its per-row scale drops the trailing axis. {"step": (), "m": {path:
    spec}, "v": ...}, an INT8 moment's path ending in /q and /s."""
    pspecs = param_specs(params, ctx)

    def moments(tree) -> Dict[str, Spec]:
        out = {}
        for path, _ in named_leaves(tree):
            if path.endswith(("/q", "/s")) and path[:-2] in pspecs:
                ps = pspecs[path[:-2]]
                out[path] = ps if path.endswith("/q") else ps[:-1]
            else:
                out[path] = pspecs[path]
        return out

    return {"step": (), "m": moments(opt_state["m"]),
            "v": moments(opt_state["v"])}


def batch_specs(cfg, ctx: RunContext, kind: str = "train") -> Dict[str, Spec]:
    b = ctx.batch_spec()[0]
    specs = {"tokens": _norm((b, None))}
    if cfg.frontend.kind != "none":
        specs["embeds"] = _norm((b, None, None))
    return specs


def _state_leaf_spec(shape: Tuple[int, ...], ctx: RunContext) -> Spec:
    """The JAX package's rule on the stacked leaf (G, *shape), G dropped."""
    b = ctx.batch_spec()[0]
    seq_axes = (ctx.model_axis,) if ctx.batch_sharded else (
        tuple(ctx.data_axes) + (ctx.model_axis,))
    nd = len(shape) + 1
    seq_ok = nd >= 4 and shape[1] % _axis_size(ctx, seq_axes) == 0
    if nd in (4, 5):   # KV (G,B,S,Hkv,hd), mLSTM C; scales, mamba h, conv
        return _norm((b, seq_axes if seq_ok else None) + (None,) * (nd - 3))
    if nd >= 2:
        return _norm((b,) + (None,) * (nd - 2))
    return ()


def decode_state_specs(cfg, state: dict,
                       ctx: RunContext) -> Dict[str, Spec]:
    """{path: spec} of a decode state (``lm.init_decode_state``): every
    cache leaf at ``caches/<layer>/<key>``, and ``pos`` replicated."""
    specs = {path: _state_leaf_spec(tuple(leaf.shape), ctx)
             for path, leaf in named_leaves(state["caches"], "caches/")}
    specs["pos"] = ()
    return specs


def to_placements(spec: Spec, mesh_axes: Tuple[str, ...]) -> Tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on a mesh
    with axes ``mesh_axes``: per mesh dim, ``Shard(d)`` for the tensor dim
    d that names it, else ``Replicate()``. A dim split over several axes
    lists them major first, which is the mesh's order in every spec here,
    as a DTensor splits a dim sharded on several mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        for name in names:
            if name in where:
                raise ValueError(f"{spec}: mesh axis {name!r} used twice")
            where[name] = d
    unknown = set(where) - set(mesh_axes)
    if unknown:
        raise ValueError(f"{spec}: axes {sorted(unknown)} not in mesh "
                         f"{mesh_axes}")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_axes)


def local_shape(shape: Tuple[int, ...], spec: Spec,
                ctx: RunContext) -> Tuple[int, ...]:
    """A device's block of a tensor of ``shape`` placed by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-dim // _axis_size(ctx, ax))
                 for dim, ax in zip(shape, spec))


def device_bytes(tree: Any, specs: Dict[str, Spec], ctx: RunContext,
                 prefix: str = "") -> int:
    """Bytes one device holds of ``tree`` placed by ``specs`` ({path:
    spec}, the paths under ``prefix``)."""
    total = 0
    for path, leaf in named_leaves(tree, prefix):
        spec: Optional[Spec] = specs.get(path)
        shape = (local_shape(tuple(leaf.shape), spec, ctx)
                 if spec is not None else tuple(leaf.shape))
        total += math.prod(shape) * leaf.element_size()
    return total


__all__ = ["Spec", "batch_specs", "decode_state_specs", "device_bytes",
           "local_shape", "named_leaves", "opt_state_specs", "param_specs",
           "path_str", "spec_for_path", "to_placements"]
