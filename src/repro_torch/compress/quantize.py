"""Symmetric quantization, the one implementation both tracks share: real
INT8 storage of the LM's linears (``quantize_lm_params``), and the CNN
track's simulated INT8 (``fake_quant_tree``: weights quantized and
dequantized in place, sizes counted at 1 B a quantized parameter); and the
byte accounting of the HQP manifest."""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.compress.qtypes import QuantizedLinear
from repro_torch.kernels.ref import ieee_div

EPS = 1e-8          # amax floor: all-zero slices get scale EPS/qmax, q == 0
MIN_FAKE_SIZE = 64  # leaves below this stay FP in the simulated track

QUANT_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down",
                     "in_proj", "out_proj", "frontend")


def symmetric_quantize(w: torch.Tensor, bits: int = 8,
                       dims: Optional[Tuple[int, ...]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q = clip(round(w/s), ±qmax), s = max(amax, EPS)/qmax in f32.

    ``dims``: reduction dims for amax (None = per-tensor). Returns (q float,
    scale with ``dims`` kept as size-1 dims). ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the codes equal the reference's."""
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.float()
    dims = tuple(range(wf.ndim)) if dims is None else dims
    if wf.numel():
        amax = wf.abs().amax(dim=dims, keepdim=True)
    else:   # an empty leaf (a family HQP cut to nothing): an all-zero one's
        amax = wf.new_zeros([1 if i in dims else n
                             for i, n in enumerate(wf.shape)])
    scale = ieee_div(torch.clamp_min(amax, EPS), qmax)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax)
    return q, scale


def _granularity_axes(ndim: int, granularity: str) -> Tuple[int, ...]:
    if granularity == "tensor":
        return tuple(range(ndim))
    return tuple(range(ndim - 1))        # per output channel (last axis)


def fake_quant(w: torch.Tensor, bits: int = 8,
               granularity: str = "tensor") -> torch.Tensor:
    """Dequantized-after-quantize weights (accuracy-simulation path)."""
    q, scale = symmetric_quantize(w, bits, _granularity_axes(w.ndim,
                                                             granularity))
    return (q * scale).to(w.dtype)


def fake_quant_tree(params: Any, bits: int = 8, granularity: str = "tensor",
                    min_size: int = MIN_FAKE_SIZE) -> Any:
    """Fake-quantize every weight leaf with >= min_size elements (CNN
    track). BN params and stats and small vectors stay FP32 (TensorRT folds
    or keeps them)."""
    def fq(leaf):
        if leaf.ndim >= 2 and leaf.numel() >= min_size:
            return fake_quant(leaf, bits, granularity)
        return leaf
    return tree.map_(fq, params)


def quantize_linear(p: Any, bits: int = 8) -> QuantizedLinear:
    """{"w": (..., in, out)} (or a bare tensor) -> QuantizedLinear, with one
    scale per output channel within each leading index. A stacked leaf (an
    MoE layer's experts) is quantized one leading index at a time, into
    preallocated codes: the f32 temporaries then hold one (in, out) matrix,
    not the whole leaf (53.6 GB at arctic-480b's experts). Each index's
    codes and scales are those of the whole leaf's: the reduction runs over
    ``in`` only."""
    w = p["w"] if isinstance(p, dict) else p
    w3 = w.reshape(math.prod(w.shape[:-2]), *w.shape[-2:])
    w_q = torch.empty(w3.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((w3.shape[0], w.shape[-1]), dtype=torch.float32,
                        device=w.device)
    # a meta tensor (the dry run) has no values: shapes and dtypes only
    for i in range(w3.shape[0] if w.device.type != "meta" else 0):
        q, s = symmetric_quantize(w3[i], bits, dims=(0,))
        w_q[i], scale[i] = q, s[0]
    return QuantizedLinear(w_q=w_q.reshape(w.shape),
                           scale=scale.reshape(*w.shape[:-2], w.shape[-1]),
                           bits=bits)


def quantize_lm_params(params: Any, bits: int = 8,
                       skip: Tuple[str, ...] = ("router", "dt_proj", "x_proj"),
                       ) -> Any:
    """Walk the LM param tree and replace quantizable linears with
    ``QuantizedLinear``. Embeddings and norms stay high-precision."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            if ("w" in tree and isinstance(tree["w"], torch.Tensor)
                    and tree["w"].ndim >= 2
                    and path and path[-1] in QUANT_LINEAR_KEYS
                    and not any(s in path for s in skip)):
                return quantize_linear(tree, bits)
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        return tree
    return walk(params)


# ------------------------------------------------------------------ accounting
def quantized_fraction(params: Any) -> float:
    """Fraction of parameter *bytes* held in int8."""
    int8 = total = 0
    for leaf in tree.leaves(params):
        b = leaf.numel() * leaf.element_size()
        total += b
        if leaf.dtype == torch.int8:
            int8 += b
    return int8 / max(total, 1)


def model_bytes(params: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree.leaves(params))


def simulated_int8_bytes(params: Any, min_size: int = MIN_FAKE_SIZE) -> int:
    """Deployed-size accounting for the fake-quant (CNN) track: leaves the
    simulation quantized count 1 B/param, the FP remainder its real width."""
    total = 0
    for leaf in tree.leaves(params):
        if leaf.ndim >= 2 and leaf.numel() >= min_size:
            total += leaf.numel()
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def simulated_quantized_fraction(params: Any,
                                 min_size: int = MIN_FAKE_SIZE) -> float:
    q = total = 0
    for leaf in tree.leaves(params):
        b = leaf.numel() * leaf.element_size()
        total += b
        if leaf.ndim >= 2 and leaf.numel() >= min_size:
            q += b
    return q / max(total, 1)
