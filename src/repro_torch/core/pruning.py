"""Global sensitivity ranking and mask/compact application (Algorithm 1
support).

The ranked list R (ascending S, paper line 8) is built once from the single
Fisher pass; the conditional loop then asks for "the masked model at
cumulative drop count n", recomputed from R each iteration. The ranking is
taken in numpy with the JAX package's sort kinds (``np.argsort`` within a
family, a stable sort across families), so equal S values break ties as the
reference does."""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import sensitivity as sens
from repro_torch.weights import block_period


@dataclasses.dataclass
class RankedUnits:
    """Global ascending-S ranking over all structural units."""
    specs: List[sens.GroupSpec]
    spec_idx: np.ndarray        # (total,) which family
    unit_idx: np.ndarray        # (total,) unit within family
    s_values: np.ndarray        # (total,) ascending

    @property
    def total(self) -> int:
        return len(self.s_values)

    def drops_per_spec(self, n_drop: int) -> List[np.ndarray]:
        """Unit indices dropped in each family for cumulative count n_drop,
        in ranking order."""
        sel_spec = self.spec_idx[:n_drop]
        sel_unit = self.unit_idx[:n_drop]
        return [sel_unit[sel_spec == i] for i in range(len(self.specs))]


def rank_units(specs: Sequence[sens.GroupSpec], sq_grads: Any,
               protect_frac: float = 0.0) -> RankedUnits:
    """Build R. ``protect_frac``: never rank the top-S fraction of each
    family (guards against emptying a whole layer; 0 = the paper's pure
    ranking)."""
    all_s, all_spec, all_unit = [], [], []
    for i, sp in enumerate(specs):
        s = sens.group_sensitivity(sq_grads, sp).cpu().numpy()
        n_rankable = sp.size - int(np.ceil(protect_frac * sp.size))
        order = np.argsort(s)[:n_rankable]
        all_s.append(s[order])
        all_spec.append(np.full(len(order), i))
        all_unit.append(order)
    s_cat = np.concatenate(all_s)
    spec_cat = np.concatenate(all_spec)
    unit_cat = np.concatenate(all_unit)
    g_order = np.argsort(s_cat, kind="stable")
    return RankedUnits(list(specs), spec_cat[g_order], unit_cat[g_order],
                       s_cat[g_order])


def apply_prune_masks(params: Any, ranked: RankedUnits, n_drop: int) -> Any:
    """Masked (shape-preserving) model with the first n_drop units of R
    zeroed, a masked expert also made unroutable; ``params`` is not
    modified."""
    for spec, drops in zip(ranked.specs, ranked.drops_per_spec(n_drop)):
        if len(drops) == 0:
            continue
        dvec = np.zeros((spec.size,), bool)
        dvec[drops] = True
        params = sens.mask_group(params, spec, torch.from_numpy(dvec))
        if spec.kind == "expert":
            params = _disable_router_cols(params, spec, dvec)
    return params


def _disable_router_cols(params: Any, spec: sens.GroupSpec,
                         dvec: np.ndarray) -> Any:
    """A masked expert's router bias becomes -1e9: its probability is then
    exactly 0 and top-k never picks it over a live expert."""
    path = next(mm[0] for mm in spec.members_all
                if "router" in mm[0])[:-1] + ("b",)
    b = sens._get(params, path)
    drop = torch.from_numpy(dvec).to(b.device)
    return sens._set(params, path, torch.where(drop, -1e9, b))


def compact_params(params: Any, ranked: RankedUnits, n_drop: int) -> Any:
    """Physically remove the first n_drop units of R (deployment artifact).

    A family of the CNNs (or any family outside ``blocks``) is compacted
    exactly: it keeps its own undropped units. The LM's families are one
    layer's each (``("blocks", g, ...)``), and the layers of one kind at
    one position of the pattern's period (``weights.block_period``) stay
    SHAPE-UNIFORM, as the JAX package's stacked layers must: each keeps
    ``size - min_g(dropped_g)`` units, and a more-pruned layer pads with
    its own *masked* (zeroed) units, lowest rank first, so the compacted
    model computes exactly what the masked model computed and its shapes
    equal the JAX artifact's. Call with the MASKED params."""
    layered = {}
    period = block_period(params["blocks"]) if "blocks" in params else 1
    for spec, drops in zip(ranked.specs, ranked.drops_per_spec(n_drop)):
        if spec.members_all[0][0][0] == "blocks":
            key = (spec.kind, spec.members_all[0][0][1] % period,
                   tuple((mm[0][2:], mm[1], mm[2], mm[3])
                         for mm in spec.members_all), spec.size)
            layered.setdefault(key, []).append((spec, drops))
        elif len(drops):
            params = sens.compact_group(
                params, spec, np.setdiff1d(np.arange(spec.size), drops))
    for (_, _, _, size), entries in layered.items():
        n_keep = size - min(len(d) for _, d in entries)
        if n_keep == size:
            continue
        for spec, drops in entries:
            kept = np.setdiff1d(np.arange(size), drops)
            pad = np.asarray(drops, int)[: n_keep - len(kept)]
            params = sens.compact_group(params, spec,
                                        np.sort(np.concatenate([kept, pad])))
    return params


def sparsity_report(ranked: RankedUnits, n_drop: int) -> dict:
    """Per-family sparsity θ (the paper's §V-C non-uniform layer analysis)."""
    rep = {}
    for spec, drops in zip(ranked.specs, ranked.drops_per_spec(n_drop)):
        rep[spec.name] = {"kind": spec.kind, "size": spec.size,
                          "dropped": int(len(drops)),
                          "theta": len(drops) / spec.size}
    return rep


def param_bytes(params: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree.leaves(params))
