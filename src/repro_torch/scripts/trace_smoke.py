"""CI trace-smoke: run the engine under ``--trace-dir`` and assert the
exported Chrome trace is well-formed AND internally consistent.

  PYTHONPATH=src python -m repro_torch.scripts.trace_smoke --device cpu

(on the card unless ``--device`` names another device, which it forwards).
What it proves (the observability contract, over a real subprocess):

  * ``serve --smoke --engine --trace-dir D`` exits 0 and writes
    ``D/trace.json`` + ``D/spans.jsonl``;
  * trace.json is a well-formed Chrome trace-event file (traceEvents
    list; every X event has ts and dur >= 0; every i event has ts) that
    Perfetto / chrome://tracing will load;
  * every submitted uid reaches exactly one terminal reason;
  * per uid, queued + active tile the request envelope: their summed
    duration matches the request span within 5% (the acceptance bound);
  * per request track, queued/active spans never overlap;
  * span token coverage: the prefill/decode/spec spans recorded for a
    uid account for every token the finish instant reports — their
    summed ``tokens`` args equal both the recorder's accumulated
    ``span_tokens`` and the engine's ``n_tokens``.
"""
from __future__ import annotations

import json
import pathlib
import signal
import subprocess
import sys
import tempfile

from repro_torch.scripts.http_smoke import (child_env, parse_args,
                                            serve_command)
from repro_torch.telemetry import schema

# an external timeout kill must raise through subprocess.run so it reaps
# the serve child: a leaked server steals the CPU and the card
signal.signal(signal.SIGTERM, lambda *_a: sys.exit(143))

TOKENS = 8
COVERAGE_TOL = 0.05   # queued+active vs request envelope (acceptance bound)
RUN_TIMEOUT_S = 540


def fail(msg: str) -> None:
    print(f"trace_smoke: FAIL: {msg}")
    raise SystemExit(1)


def check_chrome_shape(trace: dict) -> list:
    """Well-formedness: the invariants Perfetto's JSON importer needs."""
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        fail(f"traceEvents is {type(events).__name__}, want non-empty list")
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            fail(f"unexpected event phase {ph!r}: {ev}")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                fail(f"X event without numeric ts: {ev}")
            if not (isinstance(ev.get("dur"), (int, float))
                    and ev["dur"] >= 0):
                fail(f"X event with bad dur: {ev}")
        if ph == "i" and not isinstance(ev.get("ts"), (int, float)):
            fail(f"i event without numeric ts: {ev}")
        if ph != "M" and ev.get("name") not in (
                schema.SPAN_NAMES + schema.INSTANT_NAMES + ("step",)):
            fail(f"undeclared event name {ev.get('name')!r} "
                 f"(schema.SPAN_NAMES/INSTANT_NAMES): {ev}")
    return events


def check_lifecycle(records: list) -> dict:
    """Exactly one terminal per uid; spans tile and never overlap;
    span tokens account for the tokens the finish instant reports.
    Returns per-uid summary for the final print."""
    by_uid: dict = {}
    for rec in records:
        uid = rec.get("uid")
        if uid is None:
            continue
        by_uid.setdefault(uid, []).append(rec)
    if not by_uid:
        fail("no per-request records in spans.jsonl")

    for uid, recs in sorted(by_uid.items()):
        finals = [r for r in recs if r["type"] == "instant"
                  and r["name"] == "finish"]
        if len(finals) != 1:
            fail(f"uid {uid}: {len(finals)} terminal instants, want "
                 f"exactly 1 ({[f['args'] for f in finals]})")
        fin = finals[0]
        if fin["args"].get("reason") not in schema.TERMINAL_REASONS:
            fail(f"uid {uid}: terminal reason {fin['args']!r} not in "
                 f"schema.TERMINAL_REASONS")
        spans = {n: [r for r in recs if r["type"] == "span"
                     and r["name"] == n] for n in schema.SPAN_NAMES}
        if len(spans["request"]) != 1:
            fail(f"uid {uid}: {len(spans['request'])} request envelopes")
        req = spans["request"][0]
        req_dur = req["t1"] - req["t0"]

        # queued + active tile the envelope within the acceptance bound
        parts = spans["queued"] + spans["active"]
        part_dur = sum(r["t1"] - r["t0"] for r in parts)
        if req_dur > 0 and abs(part_dur - req_dur) > COVERAGE_TOL * req_dur:
            fail(f"uid {uid}: queued+active cover {part_dur:.6f}s of a "
                 f"{req_dur:.6f}s request envelope "
                 f"(off by {abs(part_dur - req_dur) / req_dur:.1%}, "
                 f"tolerance {COVERAGE_TOL:.0%})")
        # ... and never overlap each other on the track
        ordered = sorted(parts, key=lambda r: r["t0"])
        for a, b in zip(ordered, ordered[1:]):
            if b["t0"] < a["t1"] - 1e-9:
                fail(f"uid {uid}: {a['name']} [{a['t0']}, {a['t1']}] "
                     f"overlaps {b['name']} [{b['t0']}, {b['t1']}]")

        # token coverage: work spans account for every reported token
        work = spans["prefill"] + spans["decode"] + spans["spec"]
        span_tok = sum(int(r["args"].get("tokens", 0)) for r in work)
        if span_tok != fin["args"].get("span_tokens"):
            fail(f"uid {uid}: work spans carry {span_tok} tokens but the "
                 f"finish instant recorded span_tokens="
                 f"{fin['args'].get('span_tokens')!r}")
        if span_tok != fin["args"].get("n_tokens"):
            fail(f"uid {uid}: work spans emitted {span_tok} tokens but "
                 f"finish reports n_tokens="
                 f"{fin['args'].get('n_tokens')!r} (every generated token "
                 f"— prefill tail included — belongs to exactly one span)")
        by_uid[uid] = {"reason": fin["args"]["reason"],
                       "n_tokens": fin["args"].get("n_tokens", 0)}
    return by_uid


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    with tempfile.TemporaryDirectory(prefix="trace_smoke_") as tmp:
        trace_dir = pathlib.Path(tmp) / "trace"
        cmd = serve_command(args.device, "--engine", "--tokens", str(TOKENS),
                            "--trace-dir", str(trace_dir))
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=RUN_TIMEOUT_S, env=child_env())
        if proc.returncode != 0:
            fail(f"serve exited {proc.returncode}\n--- output ---\n"
                 f"{proc.stdout}\n{proc.stderr}")
        trace_path = trace_dir / "trace.json"
        jsonl_path = trace_dir / "spans.jsonl"
        for p in (trace_path, jsonl_path):
            if not p.is_file():
                fail(f"{p.name} not written under --trace-dir "
                     f"({sorted(x.name for x in trace_dir.glob('*'))})")

        trace = json.loads(trace_path.read_text())
        events = check_chrome_shape(trace)
        records = [json.loads(line)
                   for line in jsonl_path.read_text().splitlines()]
        summary = check_lifecycle(records)

    n_tok = sum(s["n_tokens"] for s in summary.values())
    print(f"trace_smoke: OK ({len(events)} trace events, "
          f"{len(summary)} request(s), {n_tok} tokens; every uid has one "
          f"terminal, queued+active tile request within {COVERAGE_TOL:.0%}, "
          f"work spans account for all tokens)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
