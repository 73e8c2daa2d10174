"""The HQP artifact: the typed, self-describing output of compression.

``compress()`` runs conditional prune (Algorithm 1) -> physical compaction
-> PTQ and returns an ``HQPArtifact`` whose ``manifest`` is the audit trail:
per-family θ, bytes before/after, quantized byte fraction, and the
accept/reject history of the conditional loop. The manifest has the JAX
package's fields and ``arch_fingerprint`` its hash, so a manifest written
by either package reads the same.

``tree_to_spec`` / ``spec_to_tree`` encode a param tree's structure (dict,
tuple, list, ``QuantizedLinear``) as the JAX package's JSON spec plus a flat
list of arrays; ``launch/checkpoint.py`` writes and reads artifacts with
them."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import tree
from repro_torch.compress import quantize as cq
from repro_torch.compress.qtypes import QuantizedLinear
from repro_torch.core import pipeline as pipe
from repro_torch.core import pruning as pr
from repro_torch.core import sensitivity as sens
from repro_torch.weights import from_numpy, to_numpy


def arch_fingerprint(cfg) -> str:
    """Stable hash of the architecture identity a speculative drafter must
    share with its verifier: vocab, positional scheme, layer pattern. Widths
    that pruning shrinks (``n_kv_heads``, ``d_ff``) are excluded, so a
    compacted artifact keeps its parent's fingerprint. The same JSON as the
    JAX package's, hence the same hash for the same config."""
    ident = {
        "name": cfg.name,
        "vocab_size": cfg.vocab_size,
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "head_dim": cfg.resolved_head_dim,
        "pattern": list(cfg.pattern),
        "qk_norm": cfg.qk_norm,
        "rope_theta": cfg.rope_theta,
        "tie_embeddings": cfg.tie_embeddings,
    }
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# ------------------------------------------------------------------ manifest
@dataclasses.dataclass
class HQPManifest:
    arch: str
    track: str                        # "int8": real int8 storage
    bits: int
    bytes_before: int
    bytes_after: int
    quantized_fraction: float
    pruned: bool                      # always True here (the JAX field)
    theta: float                      # global structural sparsity
    n_drop: int
    total_units: int
    theta_by_family: Dict[str, float]
    a_baseline: Optional[float]       # None in a JAX PTQ-only artifact
    a_final: Optional[float]
    history: List[dict]               # accept/reject audit of Algorithm 1
    vocab_size: Optional[int] = None  # absent from older JAX artifacts
    arch_hash: Optional[str] = None

    def summary(self) -> str:
        lines = [
            f"[hqp] artifact({self.arch}/{self.track}): "
            f"{self.bytes_before / 1e6:.1f}MB -> {self.bytes_after / 1e6:.1f}MB "
            f"({self.bytes_before / max(self.bytes_after, 1):.2f}x), "
            f"quantized {self.quantized_fraction:.0%} of bytes at "
            f"{self.bits}b, θ={self.theta:.1%} "
            f"({self.n_drop}/{self.total_units} units)"]
        if self.a_baseline is not None:
            lines.append(f"[hqp] accuracy {self.a_baseline:.4f} -> "
                         f"{self.a_final:.4f} over {len(self.history)} "
                         f"conditional steps")
        fams = ([f"{k}={v:.0%}" for k, v in sorted(self.theta_by_family.items())
                 if v > 0] or ["(no pruning applied)"])
        for i in range(0, len(fams), 6):
            lines.append("[hqp] θ by family: " + "  ".join(fams[i:i + 6]))
        return "\n".join(lines)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def fromdict(cls, d: dict) -> "HQPManifest":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class HQPArtifact:
    params: Any                       # deployment tree (QuantizedLinear leaves)
    manifest: HQPManifest
    # in-process only (None in a loaded artifact): the conditional prune's
    # result (masked and compacted FP params, the ranking) and the seconds
    # of each stage ("compact", "ptq"; the launcher adds "fisher", "evals")
    prune: Optional[pipe.HQPResult] = None
    seconds: Dict[str, Any] = dataclasses.field(default_factory=dict)


# ------------------------------------------------------------------ compress
def compress(params: Any, cfg, sq_grads: Any,
             eval_fn: Callable[[Any], float], hqp: pipe.HQPConfig,
             log: Callable[[str], None] = print) -> HQPArtifact:
    """Full HQP: conditional prune -> compact -> PTQ -> manifest.

    ``sq_grads`` (the Fisher diagonal, shaped like ``params``) ranks the
    LM's families (``sensitivity.lm_prune_groups``); ``eval_fn`` (params ->
    accuracy) decides each conditional step."""
    bytes_before = pr.param_bytes(params)
    res = pipe.conditional_prune(params, sens.lm_prune_groups(cfg), sq_grads,
                                 eval_fn, hqp, log=log)
    t0 = time.time()
    deploy = cq.quantize_lm_params(res.params_compact)
    tree.synchronize(deploy)
    seconds = {"compact": res.compact_seconds, "ptq": time.time() - t0}

    manifest = HQPManifest(
        arch=cfg.name, track="int8", bits=8,
        bytes_before=int(bytes_before),
        bytes_after=int(cq.model_bytes(deploy)),
        quantized_fraction=float(cq.quantized_fraction(deploy)),
        pruned=True, theta=float(res.theta),
        n_drop=int(res.n_drop), total_units=int(res.ranked.total),
        theta_by_family={k: v["theta"]
                         for k, v in res.sparsity_by_family.items()},
        a_baseline=float(res.a_baseline), a_final=float(res.a_final),
        history=[dataclasses.asdict(h) for h in res.history],
        vocab_size=cfg.vocab_size,
        arch_hash=arch_fingerprint(cfg))
    return HQPArtifact(deploy, manifest, res, seconds)


# ------------------------------------------------------------------ (de)spec
def tree_to_spec(params: Any, arrays: List[np.ndarray]) -> Any:
    """The JAX package's JSON-able structure spec of ``params`` (tensors on
    any device, in the JAX layout: ``weights.stack_blocks``); its leaves
    are appended to ``arrays`` as numpy arrays, bf16 as a uint16 view
    tagged ``"bfloat16"`` in the spec."""
    if isinstance(params, QuantizedLinear):
        slot = len(arrays)
        arrays += [to_numpy(params.w_q), to_numpy(params.scale)]
        return {"__kind__": "qlinear", "bits": params.bits, "slot": slot}
    if isinstance(params, dict):
        return {"__kind__": "dict",
                "items": {k: tree_to_spec(v, arrays)
                          for k, v in params.items()}}
    if isinstance(params, (tuple, list)):
        return {"__kind__": "tuple" if isinstance(params, tuple) else "list",
                "items": [tree_to_spec(v, arrays) for v in params]}
    if params is None:
        return {"__kind__": "none"}
    slot = len(arrays)
    arrays.append(to_numpy(params))
    return {"__kind__": "leaf", "slot": slot,
            "dtype": str(params.dtype).removeprefix("torch.")}


def spec_to_tree(spec: Any, arrays: List[np.ndarray]) -> Any:
    """The inverse of ``tree_to_spec``: a tree of CPU tensors (still in the
    JAX layout), from either package's spec."""
    kind = spec["__kind__"]
    if kind == "qlinear":
        return QuantizedLinear(from_numpy(arrays[spec["slot"]]),
                               from_numpy(arrays[spec["slot"] + 1]),
                               spec["bits"])
    if kind == "dict":
        return {k: spec_to_tree(v, arrays) for k, v in spec["items"].items()}
    if kind in ("tuple", "list"):
        seq = [spec_to_tree(v, arrays) for v in spec["items"]]
        return tuple(seq) if kind == "tuple" else seq
    if kind == "none":
        return None
    if kind != "leaf":
        raise ValueError(f"unknown artifact tree node {kind!r}")
    return from_numpy(arrays[spec["slot"]], bf16=spec["dtype"] == "bfloat16")
