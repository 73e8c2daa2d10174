"""The JAX package's tree layout and numpy leaves, in and out of the port.

The JAX tree's ``blocks`` is a tuple of one stacked dict per position of
the layer pattern's period: layer ``g·P + j`` is ``blocks[j][g]`` (P = 1
for the all-attn families, 2 for the hybrid and xLSTM smoke configs, 8
for jamba and xlstm-1.3b);
the port keeps a list of per-layer dicts in layer order. ``unstack_blocks`` and ``stack_blocks`` convert
between the two (``from_jax_params`` carries a JAX param tree across;
``launch/checkpoint.py`` writes and reads checkpoints and artifacts in the
JAX package's layout; ``from_jax_cnn_variables`` carries the CNN variables
across, whose layout the port keeps). Nothing here imports the JAX package or
``ml_dtypes``: a bf16 numpy leaf (dtype name ``bfloat16``) or a bf16 array
stored as uint16 crosses through a 16-bit view."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.compress.qtypes import QuantizedLinear
from repro_torch.models.lm import least_period


def from_numpy(arr: np.ndarray, bf16: bool = False) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr``. A bf16 array (dtype name
    ``bfloat16``, or 16-bit codes with ``bf16``) is read through a 16-bit
    view."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:      # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    if bf16 or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy array of ``t``'s values; bf16 as a uint16 view of its bits
    (numpy has no bf16), the form both packages store it in."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _n_layers(stacked) -> int:
    if isinstance(stacked, QuantizedLinear):
        return stacked.w_q.shape[0]
    if isinstance(stacked, dict):
        return _n_layers(next(iter(stacked.values())))
    return stacked.shape[0]


def _layer(stacked, i: int):
    if isinstance(stacked, QuantizedLinear):
        return QuantizedLinear(stacked.w_q[i].contiguous(),
                               stacked.scale[i].contiguous(), stacked.bits)
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i].contiguous()


def _stack(layers: list, where: str):
    first = layers[0]
    if isinstance(first, QuantizedLinear):
        return QuantizedLinear(
            _stack([q.w_q for q in layers], where + "/w_q"),
            _stack([q.scale for q in layers], where + "/scale"), first.bits)
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in layers], f"{where}/{k}")
                for k in first}
    shapes = sorted({tuple(t.shape) for t in layers})
    if len(shapes) > 1:
        raise ValueError(f"{where}: the layers' shapes differ {shapes}; "
                         f"ragged per-layer widths cannot be stacked")
    return torch.stack(layers)


def unstack_blocks(tree: Any) -> Any:
    """The JAX tree stacks the layers along axis 0 of every block leaf,
    one stacked dict per period position (an MoE layer's expert leaves
    stack to (G, E, K, N), their INT8 scales to (G, E, N)).
    Split every ``blocks`` in ``tree`` (nested in dicts, lists and tuples:
    the params, or the moments of an optimizer state) into the port's list
    of per-layer dicts, in layer order."""
    if isinstance(tree, dict):
        return {k: (_unstack(v) if k == "blocks" else unstack_blocks(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unstack_blocks(v) for v in tree)
    return tree


def _unstack(stacked) -> list:
    groups = {_n_layers(pos) for pos in stacked}
    if len(groups) != 1:
        raise ValueError(f"period positions stack {sorted(groups)} layers; "
                         f"they must stack the same number")
    return [_layer(pos, g) for g in range(groups.pop()) for pos in stacked]


def _signature(layer: dict) -> tuple:
    """What the JAX package's period is made of, read off one layer's
    keys: its block (attn, mamba, mlstm or slstm) and whether its FFN is
    the experts."""
    return (tuple(sorted(k for k in layer
                         if k in ("attn", "mamba", "mlstm", "slstm"))),
            "moe" in layer)


def block_period(layers: list) -> int:
    """The least period of the layers' signatures: ``lm.pattern_period``
    of the config they were made for."""
    return least_period([_signature(layer) for layer in layers])


def _stack_layers(layers: list) -> tuple:
    period = block_period(layers)
    return tuple(_stack(layers[j::period], f"blocks/{j}")
                 for j in range(period))


def stack_blocks(tree: Any) -> Any:
    """The inverse of ``unstack_blocks``: every ``blocks`` list of per-layer
    dicts becomes the JAX tree's tuple of one dict per period position
    (``block_period``), whose leaves stack that position's layers along
    axis 0. Raises ``ValueError`` when a leaf's shape differs between the
    layers of one position (a per-layer HQP cut)."""
    if isinstance(tree, dict):
        return {k: (_stack_layers(list(v)) if k == "blocks"
                    else stack_blocks(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stack_blocks(v) for v in tree)
    return tree


def to_device(tree: Any, device) -> Any:
    """Copy a param tree (QuantizedLinear leaves included) to ``device``."""
    if isinstance(tree, QuantizedLinear):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def from_jax_params(tree: Any, device=None) -> dict:
    """JAX LM params with numpy leaves -> the port's params on ``device``
    (default the card, as ``resolve_device`` says). A quantized linear
    (any object with ``w_q``, ``scale`` and ``bits``)
    becomes the port's ``QuantizedLinear``."""
    device = resolve_device(device)

    def conv(t):
        if all(hasattr(t, a) for a in ("w_q", "scale", "bits")):
            return QuantizedLinear(from_numpy(np.asarray(t.w_q)),
                                   from_numpy(np.asarray(t.scale)),
                                   int(t.bits))
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return [conv(v) for v in t]
        return from_numpy(np.asarray(t))
    return to_device(unstack_blocks(conv(tree)), device)


def from_jax_cnn_variables(variables: Any, device=None) -> dict:
    """The JAX package's CNN variables (``{"params", "stats"}`` of numpy
    leaves, weights HWIO) -> the port's tree on ``device`` (default the
    card, as ``resolve_device`` says), layouts unchanged."""
    return to_device(tree.map_(lambda t: from_numpy(np.asarray(t)), variables),
                     resolve_device(device))
