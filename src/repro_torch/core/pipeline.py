"""HQP conditional pruning, Algorithm 1 of the paper (§III):
M_sparse = P(M_train, τ, Δ_ax), which ``compress`` then quantizes.

Pruning proceeds in δ-sized steps down the ascending-S ranked list R and
TERMINATES the moment the validation accuracy drop exceeds Δ_ax; the last
*accepted* model is M_sparse. The returned history is the audit trail of
the accept/reject decisions."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

from repro_torch import tree
from repro_torch.core import pruning as pr
from repro_torch.core import sensitivity as sens


@dataclasses.dataclass
class HQPConfig:
    """The JAX package's HQPConfig, with its defaults. ``compress`` reads
    ``bits``, ``weight_granularity`` and ``track``; Algorithm 1 the
    step, limit and ``protect_frac``; the CNN experiment's activation
    calibration ``act_method``."""
    delta_ax: float = 0.015          # max permissible accuracy drop (1.5%)
    step_frac: float = 0.01          # δ: 1% of total structural units / step
    bits: int = 8
    weight_granularity: str = "tensor"   # paper-faithful; "channel" for LM
    act_method: str = "kl"           # absmax | percentile | kl
    max_steps: int = 200
    protect_frac: float = 0.0
    track: str = "int8"              # "int8" real storage | "fake" simulated


@dataclasses.dataclass
class PruneStep:
    step: int
    n_drop: int
    theta: float
    accuracy: float
    drop: float
    accepted: bool
    seconds: float


@dataclasses.dataclass
class HQPResult:
    params_sparse: Any               # masked, maximal compliant (M_sparse)
    params_compact: Any              # physically compacted
    ranked: pr.RankedUnits
    n_drop: int
    theta: float
    a_baseline: float
    a_final: float
    history: List[PruneStep]
    compact_seconds: float = 0.0     # the final masking and compaction

    @property
    def sparsity_by_family(self):
        return pr.sparsity_report(self.ranked, self.n_drop)


def conditional_prune(params: Any,
                      specs: List[sens.GroupSpec],
                      sq_grads: Any,
                      eval_fn: Callable[[Any], float],
                      hqp: HQPConfig,
                      a_baseline: Optional[float] = None,
                      log: Callable[[str], None] = print) -> HQPResult:
    """Algorithm 1. eval_fn: masked params -> accuracy in [0, 1]; the
    baseline is ``a_baseline`` when given, else eval_fn's first call, on the
    unpruned params."""
    ranked = pr.rank_units(specs, sq_grads, hqp.protect_frac)
    if a_baseline is None:
        a_baseline = eval_fn(params)
    delta = max(1, int(hqp.step_frac * ranked.total))
    log(f"[hqp] baseline acc={a_baseline:.4f}  units={ranked.total}  "
        f"δ={delta}  Δ_ax={hqp.delta_ax}")

    history: List[PruneStep] = []
    best_n, best_acc = 0, a_baseline
    n_drop = 0
    for t in range(1, hqp.max_steps + 1):
        n_drop = min(n_drop + delta, ranked.total)
        t0 = time.time()
        candidate = pr.apply_prune_masks(params, ranked, n_drop)
        acc = float(eval_fn(candidate))
        dt = time.time() - t0
        drop = a_baseline - acc
        accepted = drop <= hqp.delta_ax
        theta = n_drop / ranked.total
        history.append(PruneStep(t, n_drop, theta, acc, drop, accepted, dt))
        log(f"[hqp] step {t:3d} θ={theta:5.1%} acc={acc:.4f} "
            f"drop={drop:+.4f} {'ACCEPT' if accepted else 'REJECT -> stop'}")
        if not accepted:
            break
        best_n, best_acc = n_drop, acc
        if n_drop >= ranked.total:
            break

    t0 = time.time()
    params_sparse = pr.apply_prune_masks(params, ranked, best_n)
    # compact from the MASKED params: padding units must carry zeros so the
    # compacted artifact == the validated masked model
    params_compact = pr.compact_params(params_sparse, ranked, best_n)
    tree.synchronize(params_compact)
    return HQPResult(params_sparse, params_compact, ranked, best_n,
                     best_n / ranked.total, a_baseline, best_acc, history,
                     time.time() - t0)
