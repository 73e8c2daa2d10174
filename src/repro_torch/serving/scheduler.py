"""Scheduling policy for the continuous-batching engine.

The scheduler is pure host-side policy: it looks at slot metadata and picks
the next device action. Invariants (see DESIGN.md §9):

  * one prefill *chunk* per tick, never a whole prompt — chunked prefill is
    what bounds the decode stall other requests see while a long prompt is
    admitted (HALP's point: measure latency under the real serving regime);
  * prefill has priority over decode (round-robin across prefilling slots),
    so a newly admitted request reaches its first token in
    ceil(prompt/chunk) ticks regardless of how many slots are decoding;
  * decode is one batched dispatch over *all* decoding slots — slots never
    run separate decode dispatches — and each dispatch runs ``decode_steps``
    device steps before syncing tokens back to the host;
  * every KV attend carries a static visible window: the live length bound
    bucketed up to ``window_block`` (``visible_window``), so attend traffic
    and compile count both stay bounded;
  * admission is eager: a free slot + a waiting request always admits before
    the tick's action is chosen (the engine owns admission; the scheduler
    only sequences work already placed in slots).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

PREFILL = "prefill"
DECODE = "decode"
IDLE = "idle"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    prefill_chunk: int = 16     # max prompt tokens per prefill dispatch
    decode_steps: int = 4       # device decode steps per host sync (lax.scan
                                # length inside Engine._decode_fn; 1 = the
                                # per-tick-sync legacy behavior)
    window_block: int = 16      # visible-window bucket: KV attends read
                                # ceil(needed/window_block) blocks, and each
                                # distinct bucket compiles one executable
                                # (<= max_seq/window_block variants total)


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str                             # "prefill" | "decode" | "idle"
    slot: Optional[int] = None            # prefill: which slot
    slots: Tuple[int, ...] = ()           # decode: which slots step


class Scheduler:
    """Round-robin chunked prefill interleaved with batched decode."""

    def __init__(self, cfg: Optional[SchedulerConfig] = None):
        self.cfg = cfg or SchedulerConfig()
        self._rr = 0                       # round-robin cursor over slots

    def next_action(self, prefilling: Sequence[int],
                    decoding: Sequence[int]) -> Action:
        """``prefilling``/``decoding``: slot indices by lifecycle stage."""
        if prefilling:
            order = sorted(prefilling)
            pick = next((s for s in order if s >= self._rr), order[0])
            self._rr = pick + 1
            return Action(PREFILL, slot=pick)
        self._rr = 0
        if decoding:
            return Action(DECODE, slots=tuple(sorted(decoding)))
        return Action(IDLE)

    def chunk_bounds(self, prompt_len: int, done: int) -> Tuple[int, int]:
        """Next prefill chunk [lo, hi) for a prompt with ``done`` tokens
        already in the cache. The final chunk keeps its exact remainder
        length (no padding: padded prompt tokens would alter outputs)."""
        lo = done
        hi = min(prompt_len, done + self.cfg.prefill_chunk)
        return lo, hi

    def visible_window(self, needed: int, max_seq: int,
                       page_multiple: int = 0) -> int:
        """Static KV-attend window for a dispatch that reads cache positions
        [0, needed): ``needed`` bucketed up to a ``window_block`` multiple
        (bounding recompiles) and clamped to the cache capacity.

        ``page_multiple`` (paged-KV engines pass their page size) rounds the
        bucketed window up to a whole-page multiple so the page-table prefix
        the attend walks is block-aligned — without it every distinct
        (window % page_size) residue would compile its own gather. The
        rounded window may exceed ``max_seq``; the page-table prefix clamps
        to the table width and out-of-window positions mask to exact
        zeros."""
        wb = self.cfg.window_block
        w = min(max_seq, max(wb, -(-needed // wb) * wb))
        if page_multiple:
            w = -(-w // page_multiple) * page_multiple
        return w
