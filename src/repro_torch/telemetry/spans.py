"""Per-request span recorder and trace exporters.

The recorder is a passive sink: it NEVER reads a clock. Every record
method takes explicit timestamps measured by the caller (the engine's
injectable ``clock``), so the pump-thread-only discipline holds by
construction: there is exactly one component that decides what time it
is, and it is injected.

Granularity is the host sync: the engine learns what happened (which
slots emitted, what was accepted) only when it harvests a scan or a
prefill tail, so spans are recorded at those points with the
timestamps taken around the dispatch. Per request the track is:

  request   submit -> terminal            (top-level envelope)
  queued    submit -> admit               (waiting for a slot)
  active    admit  -> terminal            (holding a slot)
  prefill   one span per chunk            (args: lo, hi, tokens)
  decode    one span per scan the slot    (args: tokens, k_steps)
            participated in
  spec      one span per speculative      (args: tokens, drafted,
            cycle                          accepted, k, cycles)
  first_token / finish instants           (finish args: reason,
                                           n_tokens, pages_held)

``queued + active`` therefore tiles ``request`` exactly, and per-track
spans never overlap (``tests/test_torch_service.py`` asserts both). Sheds happen before a uid exists, so they are
engine-track instants with a shed counter, not request tracks.

Exports: Chrome trace-event JSON (load via Perfetto -> "Open trace
file") and a flat JSONL stream, one record per line.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .metrics import dumps_compact

__all__ = ["SpanRecorder"]

# Chrome tids: 0 is the engine/step track; request uid u maps to u + 1
_ENGINE_TID = 0


class SpanRecorder:
    def __init__(self):
        # flat event log: dicts with type "span" | "instant"
        self.records: List[dict] = []
        # uid -> {"t_submit", "t_admit", "prompt_len", "tokens"}
        self._live: Dict[int, dict] = {}
        # uid -> terminal reason (exactly-one-terminal bookkeeping)
        self.terminals: Dict[int, str] = {}
        self.sheds = 0

    # ------------------------------------------------------ lifecycle
    def submit(self, uid: int, t: float, prompt_len: int) -> None:
        self._live[uid] = {"t_submit": t, "t_admit": None,
                           "prompt_len": prompt_len, "tokens": 0}

    def admit(self, uid: int, t: float, slot: int) -> None:
        info = self._live.get(uid)
        if info is not None:
            info["t_admit"] = t
            info["slot"] = slot

    def span(self, name: str, uid: Optional[int], t0: float, t1: float,
             **args) -> None:
        """A completed slice (prefill chunk, decode scan, spec cycle,
        or an engine-track step phase when uid is None)."""
        info = self._live.get(uid) if uid is not None else None
        if info is not None:
            info["tokens"] += int(args.get("tokens", 0))
        self.records.append({"type": "span", "name": name, "uid": uid,
                             "t0": t0, "t1": t1, "args": args})

    def instant(self, name: str, uid: Optional[int], t: float,
                **args) -> None:
        self.records.append({"type": "instant", "name": name, "uid": uid,
                             "t": t, "args": args})

    def first_token(self, uid: int, t: float) -> None:
        self.instant("first_token", uid, t)

    def finish(self, uid: int, t: float, reason: str,
               n_tokens: int = 0, pages_held: int = 0) -> None:
        """Terminal for a submitted uid; emits the envelope spans."""
        info = self._live.pop(uid, None)
        if info is None:
            # unknown or already-terminal uid: record the anomaly (the
            # lifecycle tests assert exactly one terminal per uid) but
            # never throw on the pump thread
            self.terminals.setdefault(uid, reason)
            self.instant("finish", uid, t, reason=reason,
                         n_tokens=n_tokens, duplicate=True)
            return
        self.terminals[uid] = reason
        t_submit, t_admit = info["t_submit"], info["t_admit"]
        # uid already popped from _live, so these envelope spans do not
        # double-count into the per-request token tally
        self.span("request", uid, t_submit, t,
                  prompt_len=info["prompt_len"])
        if t_admit is not None:
            self.span("queued", uid, t_submit, t_admit)
            self.span("active", uid, t_admit, t)
        else:
            # cancelled/evicted while still waiting: queued covers all
            self.span("queued", uid, t_submit, t)
        self.instant("finish", uid, t, reason=reason, n_tokens=n_tokens,
                     pages_held=pages_held, span_tokens=info["tokens"])

    def shed(self, t: float, reason: str) -> None:
        self.sheds += 1
        self.instant("shed", None, t, reason=reason)

    # -------------------------------------------------------- exports
    def _tid(self, rec: dict) -> int:
        uid = rec.get("uid")
        return _ENGINE_TID if uid is None else int(uid) + 1

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON; microsecond timestamps, one thread
        per request plus thread 0 for engine step phases."""
        events = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                   "args": {"name": "repro-serving"}},
                  {"name": "thread_name", "ph": "M", "pid": 0,
                   "tid": _ENGINE_TID, "args": {"name": "engine"}}]
        named = set()
        for rec in self.records:
            tid = self._tid(rec)
            if tid != _ENGINE_TID and tid not in named:
                named.add(tid)
                events.append({"name": "thread_name", "ph": "M", "pid": 0,
                               "tid": tid,
                               "args": {"name": f"req {tid - 1}"}})
            args = dict(rec["args"])
            if rec.get("uid") is not None:
                args["uid"] = rec["uid"]
            if rec["type"] == "span":
                events.append({"name": rec["name"], "ph": "X", "pid": 0,
                               "tid": tid, "cat": "serving",
                               "ts": rec["t0"] * 1e6,
                               "dur": max(0.0, (rec["t1"] - rec["t0"]) * 1e6),
                               "args": args})
            else:
                events.append({"name": rec["name"], "ph": "i", "s": "t",
                               "pid": 0, "tid": tid, "cat": "serving",
                               "ts": rec["t"] * 1e6, "args": args})
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def to_jsonl(self) -> str:
        return "".join(dumps_compact(rec) + "\n" for rec in self.records)

    # ------------------------------------------------------- analysis
    def open_uids(self) -> list:
        """Submitted uids with no terminal yet (drain checks)."""
        return sorted(self._live)


def write_trace(trace_dir, recorder: SpanRecorder) -> tuple:
    """Write trace.json (Chrome/Perfetto) + spans.jsonl under trace_dir;
    returns the two paths."""
    import pathlib

    d = pathlib.Path(trace_dir)
    d.mkdir(parents=True, exist_ok=True)
    trace_path = d / "trace.json"
    jsonl_path = d / "spans.jsonl"
    trace_path.write_text(dumps_compact(recorder.to_chrome_trace()))
    jsonl_path.write_text(recorder.to_jsonl())
    return trace_path, jsonl_path
