"""Production mesh construction (the JAX package's ``launch/mesh.py``).

The production meshes are plans of 256 and 512 devices: shape-only meshes
(``Mesh.devices`` empty), whose placements ``sharding.rules`` gives and
the dry run prices per device. One card holds the 1x1 mesh."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.sharding.ctx import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512): shape
    only."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device: Optional[str] = None) -> Mesh:
    """The 1x1 ("data", "model") mesh on the card (``device`` None; raises
    without one), or on the device named (``"cpu"``). Naming the card
    creates no CUDA context: a plan of the card needs none."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            resolve_device(None)        # raises, naming device="cpu"
    return Mesh(("data", "model"), (1, 1), (torch.device(device or "cuda"),))


def mesh_by_name(name: str, device: Optional[str] = None) -> Mesh:
    """``"1x1"`` (on ``device``), ``"16x16"`` or ``"2x16x16"``."""
    if name == "1x1":
        return make_host_mesh(device)
    if name in ("16x16", "2x16x16"):
        return make_production_mesh(multi_pod=name == "2x16x16")
    raise ValueError(f"unknown mesh {name!r}; known: 1x1, 16x16, 2x16x16")
