"""Carrying weights across from the JAX package.

``from_jax_params`` maps the JAX param tree (leaves as numpy arrays) into
the port's layout; ``load_artifact`` reads what the JAX package's
``launch/checkpoint.py::save_artifact`` writes. Neither imports the JAX
package or ``ml_dtypes``: a bf16 numpy leaf (dtype name ``bfloat16``) or a
bf16 array stored as uint16 crosses through a 16-bit view."""
from __future__ import annotations

import json
import pathlib
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compress.qtypes import QuantizedLinear

COMMIT_MARKER = ".COMMITTED"
ARTIFACT_MANIFEST = "manifest.json"
ARTIFACT_ARRAYS = "arrays.npz"


def _tensor(arr: np.ndarray, bf16: bool = False) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if bf16 or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _unstack_blocks(params: dict) -> dict:
    """The JAX tree stacks the layers along axis 0 of every block leaf
    (one stacked dict per period position; the all-attn pattern has one).
    Split them into the port's list of per-layer dicts."""
    stacked = params["blocks"]
    if len(stacked) != 1:
        raise NotImplementedError("only the all-attn (period 1) pattern is "
                                  "ported so far")

    def n_layers(tree):
        if isinstance(tree, QuantizedLinear):
            return tree.w_q.shape[0]
        if isinstance(tree, dict):
            return n_layers(next(iter(tree.values())))
        return tree.shape[0]

    def layer(tree, i):
        if isinstance(tree, QuantizedLinear):
            return QuantizedLinear(tree.w_q[i].contiguous(),
                                   tree.scale[i].contiguous(), tree.bits)
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i].contiguous()

    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = [layer(stacked[0], i) for i in range(n_layers(stacked[0]))]
    return out


def to_device(tree: Any, device) -> Any:
    """Copy a param tree (QuantizedLinear leaves included) to ``device``."""
    if isinstance(tree, QuantizedLinear):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def from_jax_params(tree: Any, device=None) -> dict:
    """JAX LM params with numpy leaves -> the port's params on ``device``
    (default the card, as ``resolve_device`` says). A quantized linear
    (any object with ``w_q``, ``scale`` and ``bits``)
    becomes the port's ``QuantizedLinear``."""
    device = resolve_device(device)

    def conv(t):
        if all(hasattr(t, a) for a in ("w_q", "scale", "bits")):
            return QuantizedLinear(_tensor(np.asarray(t.w_q)),
                                   _tensor(np.asarray(t.scale)), int(t.bits))
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return [conv(v) for v in t]
        return _tensor(np.asarray(t))
    return to_device(_unstack_blocks(conv(tree)), device)


def _spec_to_tree(spec: Any, arrays: List[np.ndarray]) -> Any:
    kind = spec["__kind__"]
    if kind == "qlinear":
        return QuantizedLinear(_tensor(arrays[spec["slot"]]),
                               _tensor(arrays[spec["slot"] + 1]),
                               spec["bits"])
    if kind == "dict":
        return {k: _spec_to_tree(v, arrays) for k, v in spec["items"].items()}
    if kind in ("tuple", "list"):
        return [_spec_to_tree(v, arrays) for v in spec["items"]]
    if kind == "none":
        return None
    if kind != "leaf":
        raise ValueError(f"unknown artifact tree node {kind!r}")
    return _tensor(arrays[spec["slot"]], bf16=spec["dtype"] == "bfloat16")


def load_artifact(art_dir: str, device=None) -> Tuple[dict, dict]:
    """Read an artifact directory (``manifest.json`` with its ``tree`` spec,
    plus ``arrays.npz``) into (params on ``device``, manifest dict). An
    artifact without the ``.COMMITTED`` marker is a torn write and is
    refused."""
    dev = resolve_device(device)
    base = pathlib.Path(art_dir)
    if not base.exists():
        raise FileNotFoundError(f"no artifact at {base}")
    if not (base / COMMIT_MARKER).exists():
        raise FileNotFoundError(f"artifact {base} is not committed "
                                f"(torn write)")
    meta = json.loads((base / ARTIFACT_MANIFEST).read_text())
    with np.load(base / ARTIFACT_ARRAYS) as data:
        arrays = [data[f"a{i}"] for i in range(meta["n_arrays"])]
    params = _unstack_blocks(_spec_to_tree(meta["tree"], arrays))
    return to_device(params, dev), meta["manifest"]
