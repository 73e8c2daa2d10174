"""Elastic re-meshing and straggler policies (the JAX package's
``launch/elastic.py``).

``replan(...)`` chooses a new mesh shape for the healthy device inventory
(after failures, preemptions, capacity changes), keeping the global batch
constant by adjusting the microbatch count, so the optimizer trajectory is
unchanged across re-meshes; ``rebuild`` restores the latest committed
checkpoint onto the new mesh. A plan of one device restores onto that
device; a plan of more raises, since the port does not execute sharded
placements yet (ROADMAP A14 (rest): sharded execution).

Straggler mitigation at this layer is topology-aware exclusion: a chronic
straggler is dropped from the healthy set and the mesh re-planned around
it."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.launch import checkpoint as ckpt
from repro_torch.sharding.ctx import Mesh, RunContext, make_ctx


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    num_microbatches: int
    dropped_devices: List[int]


def choose_mesh_shape(n_devices: int, model_parallel: int,
                      global_batch: int) -> Tuple[int, int]:
    """Largest (data, model) grid fitting the healthy device count, keeping
    the model axis fixed (TP width is a property of the model, not the
    fleet) and data divisible into the global batch."""
    data = n_devices // model_parallel
    while data > 1 and (global_batch % data != 0):
        data -= 1
    if data < 1:
        raise ValueError(
            f"cannot fit model_parallel={model_parallel} in {n_devices}")
    return data, model_parallel


def replan(healthy_devices: Sequence, model_parallel: int,
           global_batch: int, target_microbatch_tokens: int,
           seq_len: int) -> ElasticPlan:
    n = len(healthy_devices)
    data, model = choose_mesh_shape(n, model_parallel, global_batch)
    per_device_batch = global_batch // data
    micro = max(1, int(np.ceil(
        per_device_batch * seq_len / max(target_microbatch_tokens, 1))))
    while global_batch % (micro) or (global_batch // data) % micro:
        micro -= 1
    return ElasticPlan((data, model), ("data", "model"), max(micro, 1), [])


def _like_on(like: Any, dev: torch.device) -> Any:
    """``like``'s structure, shapes and dtypes on ``dev``, holding no
    memory (each leaf a broadcast 0-d tensor): what ``checkpoint.restore``
    reads off the tree it fills."""
    return tree.map_(lambda t: torch.empty((), dtype=t.dtype, device=dev
                                           ).expand(t.shape), like)


def rebuild(plan: ElasticPlan, devices: Sequence, params_like: Any,
            opt_like: Any, ckpt_dir: str
            ) -> Tuple[Mesh, RunContext, Any, Any, dict]:
    """Construct the plan's mesh over the first devices of ``devices``
    (torch devices or names) and restore the latest checkpoint onto it:
    (mesh, ctx, params, opt_state, meta). Only a plan of one device runs
    here; a larger one raises, naming the missing piece."""
    n = math.prod(plan.mesh_shape)
    if n != 1:
        raise NotImplementedError(
            f"rebuild onto a {plan.mesh_shape} mesh needs sharded execution "
            f"(placements applied through torch.distributed, a resharding "
            f"restore), which the port does not have yet (ROADMAP A14 "
            f"(rest)); only a 1x1 plan restores")
    dev = torch.device(devices[0])
    mesh = Mesh(plan.axis_names, plan.mesh_shape, (dev,))
    ctx = make_ctx(mesh)
    (params, opt_state), meta = ckpt.restore(
        ckpt_dir, (_like_on(params_like, dev), _like_on(opt_like, dev)))
    return mesh, ctx, params, opt_state, meta


@dataclasses.dataclass
class StragglerPolicy:
    """Exclude devices whose step time is persistently above the fleet
    median by `threshold` (e.g. 1.5x) for `patience` consecutive steps."""
    threshold: float = 1.5
    patience: int = 20

    def __post_init__(self):
        self._strikes = {}

    def observe(self, step_times_by_device: dict) -> List:
        med = float(np.median(list(step_times_by_device.values())))
        to_drop = []
        for dev, t in step_times_by_device.items():
            if t > self.threshold * med:
                self._strikes[dev] = self._strikes.get(dev, 0) + 1
                if self._strikes[dev] >= self.patience:
                    to_drop.append(dev)
            else:
                self._strikes[dev] = 0
        return to_drop
