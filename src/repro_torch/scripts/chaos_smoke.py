"""CI chaos-smoke: boot ``serve --http`` with a deliberately small paged
arena, then attack it — malformed HTTP, a slow-loris, mid-stream client
disconnects, page exhaustion, a deadline storm — and finally SIGTERM it
mid-load.

  PYTHONPATH=src python -m repro_torch.scripts.chaos_smoke --device cpu

(on the card unless ``--device`` names another device, which it forwards
to the server). What it proves (the fault-tolerance contract, over real
sockets against a real subprocess; in-process scenarios live in the
tests):

  * malformed requests (garbage line, bad JSON, non-POST generate,
    bad prompt types, oversized body) each get a clean 4xx, never a
    dropped connection or a pump exception;
  * a slow-loris client is timed out by the event loop (408/close)
    without ever touching the engine thread;
  * clients that vanish mid-stream (RST) have their requests cancelled
    and every page freed — ``pages_in_use`` returns to zero;
  * page exhaustion under concurrent load fault-isolates: every stream
    still terminates with exactly one ``done``/``error`` event, the
    server keeps answering, and no page leaks;
  * a deadline storm is absorbed by shedding (429) / expiry — never a
    5xx or a hang;
  * SIGTERM mid-load drains cleanly: in-flight streams finish, exit 0.
"""
from __future__ import annotations

import json
import signal
import subprocess
import threading
import time

from repro_torch.serving import faults
# importing http_smoke also installs its atexit child reaper and SIGTERM
# handler, and start_server registers the server with it: no fail() path
# (or external timeout kill) can leak it
from repro_torch.scripts.http_smoke import (http_exchange, parse_args,
                                            parse_sse, serve_command,
                                            start_server)

STREAM_TIMEOUT_S = 120
EXIT_TIMEOUT_S = 60
TOTAL_PAGES = 25        # 4 slots x ceil(128/8)=16 pages would need 65:
                        # deliberately starved so concurrency exhausts it
HOST = "127.0.0.1"


def fail(msg: str, proc=None) -> None:
    print(f"chaos_smoke: FAIL: {msg}")
    if proc is not None:
        proc.kill()
        out = proc.stdout.read() if proc.stdout else ""
        print(f"--- server output ---\n{out}")
    raise SystemExit(1)


def post(port: int, body: dict, timeout_s: float = STREAM_TIMEOUT_S):
    """POST /v1/generate. Returns (head, events) — SSE events for a 200
    stream, [] for an error status (429/503/...: the body is JSON, not
    SSE)."""
    payload = json.dumps(body).encode()
    raw = http_exchange(port, (
        f"POST /v1/generate HTTP/1.1\r\nHost: s\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload,
        timeout_s)
    head = raw.partition(b"\r\n\r\n")[0].decode("latin-1", "replace")
    if not head.startswith("HTTP/1.1 200"):
        return head, []
    return parse_sse(raw)


def stats(port: int) -> dict:
    raw = http_exchange(port, b"GET /stats HTTP/1.1\r\nHost: s\r\n\r\n", 30)
    return json.loads(raw.partition(b"\r\n\r\n")[2])


def wait_pages_zero(port: int, timeout_s: float = 30.0) -> dict:
    t0 = time.monotonic()
    while True:
        st = stats(port)
        if st["engine"]["pages_in_use"] == 0 and st["slots_active"] == 0:
            return st
        if time.monotonic() - t0 > timeout_s:
            fail(f"pages_in_use={st['engine']['pages_in_use']} "
                 f"slots_active={st['slots_active']} still nonzero after "
                 f"{timeout_s}s: {st}")
        time.sleep(0.2)


def expect_status(got: str, want: str, what: str, proc) -> None:
    if want not in got:
        fail(f"{what}: status {got!r} (want {want})", proc)
    print(f"chaos_smoke: {what} -> {got or '<closed>'}")


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    proc, port, boot_s = start_server(serve_command(
        args.device, "--engine", "--http", "--port", "0", "--queue-depth",
        "4", "--page-size", "8", "--no-prefix-cache", "--total-pages",
        str(TOTAL_PAGES), "--watchdog-s", "120"), fail)
    print(f"chaos_smoke: server up on port {port} ({boot_s:.0f}s boot)")

    # ---- 0. sanity: one healthy stream (also warms decode for later)
    head, events = post(port, {"prompt_len": 12, "max_new_tokens": 6})
    if not head.startswith("HTTP/1.1 200") or events[-1][0] != "done":
        fail(f"sanity stream broken: {head!r} {events!r}", proc)
    print("chaos_smoke: sanity stream OK")

    # ---- 1. malformed HTTP: every attack gets a clean 4xx
    expect_status(faults.http_malformed(HOST, port, b"garbage\r\n\r\n"),
                  "400", "garbage request line", proc)
    expect_status(faults.http_malformed(
        HOST, port, b"POST /v1/generate HTTP/1.1\r\nHost: s\r\n"
                    b"Content-Length: 7\r\n\r\n{not js"),
        "400", "malformed JSON body", proc)
    expect_status(faults.http_malformed(
        HOST, port, b"GET /v1/generate HTTP/1.1\r\nHost: s\r\n\r\n"),
        "400", "non-POST generate", proc)
    bad = json.dumps({"prompt": "strings are not token ids"}).encode()
    expect_status(faults.http_malformed(
        HOST, port, b"POST /v1/generate HTTP/1.1\r\nHost: s\r\n"
                    b"Content-Length: %d\r\n\r\n%s" % (len(bad), bad)),
        "400", "non-list prompt", proc)
    big = json.dumps({"prompt": [1] * 500, "max_new_tokens": 500}).encode()
    expect_status(faults.http_malformed(
        HOST, port, b"POST /v1/generate HTTP/1.1\r\nHost: s\r\n"
                    b"Content-Length: %d\r\n\r\n%s" % (len(big), big)),
        "400", "overlong prompt+budget", proc)
    expect_status(faults.http_malformed(
        HOST, port, b"POST /v1/generate HTTP/1.1\r\nHost: s\r\n"
                    b"Content-Length: 9999999999\r\n\r\n"),
        "413", "oversized body", proc)

    # ---- 2. slow-loris: request timeout answers 408 (or closes), the
    # pump never sees the connection
    got = faults.http_slow_loris(HOST, port, hold_s=12.0, timeout_s=30.0)
    if got and "408" not in got:
        fail(f"slow-loris got {got!r} (want 408 or close)", proc)
    print(f"chaos_smoke: slow-loris -> {got or '<closed>'}")

    # ---- 3. mid-stream disconnects: pages freed, requests cancelled
    pre = stats(port)["service"]["cancelled"]
    for _ in range(2):
        seen = faults.http_disconnect_mid_stream(
            HOST, port, {"prompt_len": 16, "max_new_tokens": 40},
            after_tokens=2)
        if seen < 1:
            fail("disconnect client saw no tokens before vanishing", proc)
    st = wait_pages_zero(port)
    if st["service"]["cancelled"] < pre + 2:
        fail(f"cancelled {st['service']['cancelled']} < {pre + 2} after "
             f"2 disconnects: {st}", proc)
    print(f"chaos_smoke: 2 disconnects cancelled "
          f"(cancelled={st['service']['cancelled']}), pages back to 0")

    # ---- 4. page exhaustion under concurrency: the starved arena cannot
    # hold 6 deep requests; every stream must still terminate with one
    # done/error event and no page may leak
    results, lock = [], threading.Lock()

    def one_stream():
        try:
            head, events = post(port, {"prompt_len": 40,
                                       "max_new_tokens": 24})
            terminal = [n for n, _ in events if n in ("done", "error")]
            with lock:
                results.append((head.split("\r\n")[0], terminal))
        except Exception as e:   # noqa: BLE001 — recorded and asserted on
            with lock:
                results.append((f"EXC {e!r}", []))

    threads = [threading.Thread(target=one_stream) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(STREAM_TIMEOUT_S)
    errors = 0
    for head_line, terminal in results:
        if "200" in head_line:
            if len(terminal) != 1:
                fail(f"stream terminal events {terminal} != exactly one",
                     proc)
            errors += terminal[0] == "error"
        elif "429" not in head_line:   # saturation shed is legal here
            fail(f"exhaustion stream got {head_line!r}", proc)
    st = wait_pages_zero(port)
    print(f"chaos_smoke: exhaustion survived — {len(results)} streams, "
          f"{errors} error-isolated, engine faults="
          f"{st['engine']['faults']}, pages back to 0")

    # ---- 5. deadline storm: tiny deadlines are shed (429) or expire —
    # never a 5xx, never a hang
    storm_codes = []
    for dl in faults.storm_deadlines(seed=7, n=8, lo_s=0.01, hi_s=0.2):
        head, events = post(port, {"prompt_len": 24, "max_new_tokens": 16,
                                   "deadline_s": round(dl, 3)})
        code = head.split("\r\n")[0].split(" ")[1]
        storm_codes.append(code)
        if code not in ("200", "429"):
            fail(f"deadline storm got {code}", proc)
    st = wait_pages_zero(port)
    print(f"chaos_smoke: deadline storm codes={storm_codes}, "
          f"expired={st['service']['expired']}, "
          f"shed_infeasible={st['service']['shed_infeasible']}")

    # ---- 6. SIGTERM mid-load: in-flight streams drain, exit 0
    live = []

    def draining_stream():
        head, events = post(port, {"prompt_len": 16, "max_new_tokens": 48})
        with lock:
            live.append((head.split("\r\n")[0], [n for n, _ in events]))

    threads = [threading.Thread(target=draining_stream) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(1.0)                   # let them admit and start decoding
    proc.send_signal(signal.SIGTERM)
    for t in threads:
        t.join(STREAM_TIMEOUT_S)
    try:
        out, _ = proc.communicate(timeout=EXIT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"server did not exit within {EXIT_TIMEOUT_S}s of SIGTERM",
             proc)
    print(f"[server] {out.strip()}" if out.strip() else
          "[server] <no further output>")
    if proc.returncode != 0:
        fail(f"exit code {proc.returncode} after SIGTERM (want 0)")
    if "drained cleanly" not in out:
        fail(f"no 'drained cleanly' line in shutdown output: {out!r}")
    for head_line, names in live:
        if "200" in head_line and (not names or
                                   names[-1] not in ("done", "error")):
            fail(f"mid-drain stream ended without terminal event: {names}")
    print("chaos_smoke: OK (malformed 4xx, slow-loris 408, disconnect "
          "cancel, exhaustion isolation, deadline storm, SIGTERM drain, "
          "zero leaked pages)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
