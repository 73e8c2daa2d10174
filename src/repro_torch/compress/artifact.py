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
    JAX package's, hence the same hash for the same config (a CNN config
    has none of the LM's fields: they hash as null)."""
    ident = {
        "name": getattr(cfg, "name", None) or getattr(cfg, "arch", "?"),
        "vocab_size": getattr(cfg, "vocab_size", None),
        "n_layers": getattr(cfg, "n_layers", None),
        "d_model": getattr(cfg, "d_model", None),
        "head_dim": (cfg.resolved_head_dim
                     if hasattr(cfg, "resolved_head_dim") else None),
        "pattern": list(getattr(cfg, "pattern", ())),
        "qk_norm": getattr(cfg, "qk_norm", None),
        "rope_theta": getattr(cfg, "rope_theta", None),
        "tie_embeddings": getattr(cfg, "tie_embeddings", None),
    }
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# ------------------------------------------------------------------ manifest
@dataclasses.dataclass
class HQPManifest:
    arch: str
    track: str                        # "int8" (LM real) | "fake" (CNN sim)
    bits: int
    bytes_before: int
    bytes_after: int
    quantized_fraction: float
    pruned: bool                      # False: a PTQ-only artifact
    theta: float                      # global structural sparsity
    n_drop: int
    total_units: int
    theta_by_family: Dict[str, float]
    a_baseline: Optional[float]       # None in a PTQ-only artifact
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
    # in-process only (None in a loaded or a PTQ-only artifact): the
    # conditional prune's result (masked and compacted FP params, the
    # ranking) and the seconds of each stage ("compact" when pruned, "ptq";
    # the launcher adds "fisher", "evals")
    prune: Optional[pipe.HQPResult] = None
    seconds: Dict[str, Any] = dataclasses.field(default_factory=dict)


# ------------------------------------------------------------------ compress
def compress(params: Any, cfg, sq_grads: Any = None,
             eval_fn: Optional[Callable[[Any], float]] = None,
             hqp: Optional[pipe.HQPConfig] = None, specs=None,
             a_baseline: Optional[float] = None,
             log: Callable[[str], None] = print) -> HQPArtifact:
    """Full HQP: conditional prune -> compact -> PTQ -> manifest.

    ``sq_grads`` (the Fisher diagonal, shaped like ``params``) and
    ``eval_fn`` (params -> accuracy, deciding each conditional step) enable
    the conditional prune; without both the prune is skipped (a PTQ-only
    artifact). ``specs`` defaults to the LM's families
    (``sensitivity.lm_prune_groups``); the CNN track passes its conv-channel
    specs, and ``a_baseline`` when it has evaluated the baseline already.
    ``hqp.track`` selects real INT8 storage ("int8") or the paper's
    simulated INT8 ("fake")."""
    if (sq_grads is None) != (eval_fn is None):
        raise ValueError(
            "compress(): sq_grads and eval_fn must be given together (both "
            "for conditional pruning, neither for a PTQ-only artifact); got "
            f"sq_grads={'set' if sq_grads is not None else 'None'}, "
            f"eval_fn={'set' if eval_fn is not None else 'None'}")
    hqp = hqp or pipe.HQPConfig(weight_granularity="channel")
    bytes_before = pr.param_bytes(params)
    arch = getattr(cfg, "name", None) or getattr(cfg, "arch", "?")

    deploy, res, seconds = params, None, {}
    a_final = a_baseline
    if sq_grads is not None:
        if specs is None:
            specs = sens.lm_prune_groups(cfg)
        res = pipe.conditional_prune(params, specs, sq_grads, eval_fn, hqp,
                                     a_baseline=a_baseline, log=log)
        deploy = res.params_compact
        a_baseline, a_final = res.a_baseline, res.a_final
        seconds["compact"] = res.compact_seconds

    t0 = time.time()
    if hqp.track == "fake":
        deploy = cq.fake_quant_tree(deploy, hqp.bits, hqp.weight_granularity)
        bytes_after = cq.simulated_int8_bytes(deploy)
        qfrac = cq.simulated_quantized_fraction(deploy)
    else:
        deploy = cq.quantize_lm_params(deploy, hqp.bits)
        bytes_after = cq.model_bytes(deploy)
        qfrac = cq.quantized_fraction(deploy)
    tree.synchronize(deploy)
    seconds["ptq"] = time.time() - t0

    manifest = HQPManifest(
        arch=arch, track=hqp.track, bits=hqp.bits,
        bytes_before=int(bytes_before), bytes_after=int(bytes_after),
        quantized_fraction=float(qfrac), pruned=res is not None,
        theta=float(res.theta) if res else 0.0,
        n_drop=int(res.n_drop) if res else 0,
        total_units=int(res.ranked.total) if res else 0,
        theta_by_family=({k: v["theta"]
                          for k, v in res.sparsity_by_family.items()}
                         if res else {}),
        a_baseline=None if a_baseline is None else float(a_baseline),
        a_final=None if a_final is None else float(a_final),
        history=[dataclasses.asdict(h) for h in res.history] if res else [],
        vocab_size=getattr(cfg, "vocab_size", None),
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
