"""Deadline-feasibility admission control, a copy of the JAX package's
``repro.serving.admission`` (pure Python; the tests hold the two equal).

A static admission bound sheds blindly: once ``n_slots + queue_depth``
requests are in flight every submit is rejected, and a request whose
deadline cannot be met is admitted anyway, burns slot time, and dies in
the deadline sweep. ``AdmissionController`` closes that loop with the
measurements the engine already produces:

  * ``observe(prefill_tokens, decode_tokens, wall_s)`` — fed one engine
    step at a time via ``observe_step(Engine.last_step)`` (the engine's
    own phase-time attribution; the service no longer re-times the step
    with a parallel clock read), it maintains two EWMAs: aggregate
    prefill throughput
    and aggregate decode throughput, in tokens/second.  Separate rates
    because the two phases have very different cost per token (a prefill
    chunk amortizes weights over many tokens; decode is one token per
    pass per slot).
  * ``feasible(prompt_len, max_new_tokens, backlog)`` — at submit time,
    predict when the new request would finish if admitted *behind* the
    current backlog (remaining prefill + decode tokens of every live
    request, which the service computes exactly from its tickets and the
    engine's per-slot prefill progress):

        predicted_s = safety * (  (backlog.prefill + prompt_len) / prefill_rate
                                + (backlog.decode  + max_new)    / decode_rate )

    The engine time-slices prefill against decode, so total completion
    time is the sum of both phases' work at their measured aggregate
    rates; ``safety`` (> 1) absorbs EWMA lag and scheduling jitter —
    shedding slightly too eagerly near the knee is the safe failure
    direction, admitting a doomed request is not.
  * an **honest Retry-After**: if the request misses its deadline by
    ``excess = predicted_s - deadline_s`` seconds, the backlog must
    drain for ``excess`` seconds before the same submit becomes
    feasible — that (clamped to ``[retry_floor_s, retry_cap_s]``) is
    what the 429 advertises, instead of a constant.

The controller is pure arithmetic over durations — no clock, no HTTP,
no engine reference — so it is unit-testable by feeding synthetic
observations; the *service* owns the (injectable) clock and the backlog
bookkeeping.  Until ``min_observations`` samples of each rate have
arrived the controller reports ``warm == False`` and the service admits
on the static bound alone (the hard cap stays regardless: feasibility
never admits past ``n_slots + queue_depth``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    ewma_alpha: float = 0.3        # EWMA smoothing: weight of the newest sample
    safety: float = 1.5            # predicted-completion multiplier (> 1);
                                   # absorbs EWMA lag + scheduling jitter
    min_observations: int = 3      # samples of EACH rate before predictions
                                   # engage (cold controller admits statically)
    retry_floor_s: float = 0.05    # Retry-After clamp (advertised honesty
    retry_cap_s: float = 30.0      # has limits: sub-50ms retries just hammer)

    def __post_init__(self):
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")
        if self.safety < 1.0:
            raise ValueError(f"safety must be >= 1, got {self.safety}")
        if self.min_observations < 1:
            raise ValueError(f"min_observations must be >= 1, got "
                             f"{self.min_observations}")
        if not (0.0 < self.retry_floor_s <= self.retry_cap_s):
            raise ValueError(f"need 0 < retry_floor_s <= retry_cap_s, got "
                             f"{self.retry_floor_s}..{self.retry_cap_s}")


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One feasibility decision: admit or shed, plus the numbers behind it
    (``predicted_s`` includes the safety factor; ``retry_after_s`` is the
    honest backlog-drain estimate, clamped)."""
    feasible: bool
    predicted_s: float
    retry_after_s: float


class AdmissionController:
    """EWMA throughput tracker + deadline-feasibility predictor."""

    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        self.prefill_tok_s: Optional[float] = None   # EWMA, tokens/second
        self.decode_tok_s: Optional[float] = None
        self._n_prefill = 0
        self._n_decode = 0

    # --------------------------------------------------------------- measure
    def observe(self, prefill_tokens: int, decode_tokens: int,
                wall_s: float) -> None:
        """Fold one engine step into the rate EWMAs. ``prefill_tokens`` /
        ``decode_tokens`` are the step's ``Engine.stats`` deltas
        (``prefill_tokens`` / ``accepted_tokens``); ``wall_s`` the step's
        wall time on the service clock. Steps that moved no tokens of a
        kind (or report a non-positive wall) leave that EWMA untouched."""
        if wall_s <= 0.0:
            return
        a = self.cfg.ewma_alpha
        if prefill_tokens > 0:
            r = prefill_tokens / wall_s
            self.prefill_tok_s = (r if self.prefill_tok_s is None
                                  else (1 - a) * self.prefill_tok_s + a * r)
            self._n_prefill += 1
        if decode_tokens > 0:
            r = decode_tokens / wall_s
            self.decode_tok_s = (r if self.decode_tok_s is None
                                 else (1 - a) * self.decode_tok_s + a * r)
            self._n_decode += 1

    def observe_step(self, last_step) -> None:
        """Fold ``Engine.last_step`` (the engine's own phase-time
        attribution, measured on the engine's injectable clock around the
        step it describes) into the EWMAs. This is the ONLY measurement
        path in serving: the service hands the engine's record straight
        here instead of re-timing ``step()`` with a second clock read and
        re-deriving token deltas from stats — one measurement, two
        consumers (these EWMAs and the phase histograms)."""
        if not last_step:
            return
        self.observe(int(last_step.get("prefill_tokens", 0)),
                     int(last_step.get("decode_tokens", 0)),
                     float(last_step.get("wall_s", 0.0)))

    @property
    def warm(self) -> bool:
        """Both rates observed at least ``min_observations`` times —
        predictions are meaningful."""
        n = self.cfg.min_observations
        return self._n_prefill >= n and self._n_decode >= n

    # --------------------------------------------------------------- predict
    def work_s(self, prefill_tokens: int, decode_tokens: int) -> float:
        """Safety-scaled wall time to move the given token counts through
        the engine at the current EWMA rates. Requires ``warm``."""
        return self.cfg.safety * (
            prefill_tokens / self.prefill_tok_s
            + decode_tokens / self.decode_tok_s)

    def clamp_retry(self, retry_s: float) -> float:
        return min(max(retry_s, self.cfg.retry_floor_s), self.cfg.retry_cap_s)

    def feasible(self, prompt_len: int, max_new_tokens: int,
                 backlog: Tuple[int, int], deadline_s: float) -> Verdict:
        """Would a request of this shape, submitted *now* behind
        ``backlog = (prefill_tokens, decode_tokens)`` of live work, finish
        within ``deadline_s``?  Requires ``warm`` (the service checks)."""
        bp, bd = backlog
        predicted = self.work_s(bp + prompt_len, bd + max_new_tokens)
        if predicted <= deadline_s:
            return Verdict(True, predicted, 0.0)
        # the backlog drains at roughly the same rates the prediction was
        # priced at, so after `excess` seconds the identical submit comes
        # in under the deadline — that is the honest Retry-After. When the
        # request's OWN work alone exceeds the deadline no retry helps;
        # the clamp still bounds what we advertise.
        excess = predicted - deadline_s
        return Verdict(False, predicted, self.clamp_retry(excess))
