"""Run context: mesh + axis-name conventions (the JAX package's
``sharding/ctx.py``).

Mesh axis conventions:
  single-pod : ("data", "model")                16 x 16
  multi-pod  : ("pod", "data", "model")         2 x 16 x 16
DP/FSDP axes = ("pod", "data") (those present); TP/EP axis = "model".

A ``Mesh`` here is given by its axis names and sizes, and by the devices
it runs on where they exist: the production meshes are plans of 256 and
512 devices that one card cannot hold (shape-only, ``devices`` empty); the
1x1 mesh of ``launch.mesh.make_host_mesh`` runs on the card. The models
take their switches as explicit arguments (``quantized_kv``,
``moe_no_drop``); the dry run reads them off the context and passes them
on."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()      # () for a shape-only plan

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} with sizes "
                             f"{self.sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"a {self.sizes} mesh over "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(map(str, self.sizes))


@dataclasses.dataclass(frozen=True)
class RunContext:
    mesh: Mesh
    data_axes: Tuple[str, ...] = ("data",)  # batch / FSDP axes (and "pod")
    model_axis: str = "model"
    batch_sharded: bool = True      # False for global_batch < |data axes|
    quantized_kv: bool = False      # INT8 KV cache for decode
    remat: bool = True
    pure_dp: bool = False           # no-TP archs (xLSTM): batch takes the
                                    # model axis too, params FSDP
    moe_no_drop: bool = True        # inference: lossless MoE dispatch; the
                                    # training launcher turns this off and
                                    # lets capacity_factor drop

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.data_axes) + (self.model_axis,)

    def batch_spec(self) -> Tuple:
        """Leading-batch-dim placement ((data axes) or replicated)."""
        if not self.batch_sharded:
            return (None,)
        if self.pure_dp:
            return (self.all_axes,)
        return (tuple(self.data_axes),)

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.data_axes)

    @property
    def tp_size(self) -> int:
        return int(self.mesh.shape[self.model_axis])


@functools.lru_cache(maxsize=1)
def default_ctx() -> RunContext:
    """The 1x1 plan of tests and smoke runs."""
    return RunContext(mesh=Mesh(("data", "model"), (1, 1)))


def make_ctx(mesh: Mesh, **kw) -> RunContext:
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    return RunContext(mesh=mesh, data_axes=data_axes, **kw)
