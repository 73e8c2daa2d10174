"""Walks over param trees: nested dicts, lists and tuples of tensors, with
``QuantizedLinear`` nodes (the port's counterpart of ``jax.tree``)."""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.compress.qtypes import QuantizedLinear


def leaves(tree: Any) -> List[torch.Tensor]:
    """Every tensor of ``tree``; a ``QuantizedLinear`` gives its codes and
    its scales."""
    if isinstance(tree, QuantizedLinear):
        return [tree.w_q, tree.scale]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def map_(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure (dicts, lists,
    tuples of tensors; no ``QuantizedLinear``), into a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def synchronize(tree: Any) -> None:
    """Wait until the card has finished the work queued on ``tree``'s
    device, so that a host-clock time of a stage includes its device work.
    Nothing to wait for on the CPU."""
    first = leaves(tree)[0]
    if first.is_cuda:
        torch.cuda.synchronize(first.device)
