"""CI http-smoke: boot ``serve --http``, stream one SSE request end to end,
assert the wire framing, then SIGTERM and assert a clean drain + exit 0.

  PYTHONPATH=src python -m repro_torch.scripts.http_smoke --device cpu

boots ``python -m repro_torch.launch.serve --smoke --engine --http --port
0`` (on the card unless ``--device`` names another device, which it
forwards). What it proves (the shutdown and streaming contract, over a real
socket against a real subprocess; the loopback tests cover the in-process
path):

  * the server comes up and prints its bound port (``--port 0``);
  * POST /v1/generate answers 200 text/event-stream with N ``token``
    events (indices 0..N-1) followed by exactly one ``done`` event;
  * GET /metrics scraped MID-STREAM (after the first token, before done)
    serves valid Prometheus text exposition covering every metric family
    the telemetry schema declares (``repro_torch.telemetry.schema``);
  * /healthz reports the completed request;
  * SIGTERM drains and the process exits 0 with the drain log line.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time

from repro_torch.telemetry import parse_exposition, schema

SRC = pathlib.Path(__file__).resolve().parents[2]

# the server child must NEVER outlive this script: a leaked `serve` process
# steals CPU (and the card) from everything that runs after it. atexit
# covers every fail() path; the SIGTERM handler
# turns an external timeout kill into a normal exit so atexit still runs.
_children: list = []


def _reap() -> None:
    for p in _children:
        if p.poll() is None:
            p.kill()
            p.wait()


atexit.register(_reap)
signal.signal(signal.SIGTERM, lambda *_a: sys.exit(143))

NEW_TOKENS = 6
BOOT_TIMEOUT_S = 420          # model init, the kernels' build, the warm-up
STREAM_TIMEOUT_S = 120
EXIT_TIMEOUT_S = 60


def fail(msg: str, proc=None) -> None:
    print(f"http_smoke: FAIL: {msg}")
    if proc is not None:
        proc.kill()
        out = proc.stdout.read() if proc.stdout else ""
        print(f"--- server output ---\n{out}")
    raise SystemExit(1)


def http_exchange(port: int, request: bytes, timeout_s: float) -> bytes:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout_s) as s:
        s.sendall(request)
        chunks = []
        while True:
            b = s.recv(65536)
            if not b:
                break
            chunks.append(b)
    return b"".join(chunks)


def stream_and_scrape(port: int, request: bytes, timeout_s: float):
    """Send the generate request, and as soon as the first ``event:
    token`` frame lands — i.e. while the stream is live and the request
    is mid-flight — scrape ``GET /metrics`` over a second connection.
    Returns (full SSE bytes, exposition text scraped mid-stream)."""
    scraped = None
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout_s) as s:
        s.sendall(request)
        buf = bytearray()
        while True:
            b = s.recv(65536)
            if not b:
                break
            buf += b
            if scraped is None and b"event: token" in buf:
                raw = http_exchange(
                    port, b"GET /metrics HTTP/1.1\r\nHost: s\r\n\r\n", 30)
                head, _, body = raw.partition(b"\r\n\r\n")
                if not head.startswith(b"HTTP/1.1 200"):
                    fail(f"/metrics status: {head.splitlines()[0]!r}")
                if b"text/plain" not in head or b"version=0.0.4" not in head:
                    fail(f"/metrics content type missing exposition tag: "
                         f"{head!r}")
                scraped = body.decode()
    return bytes(buf), scraped


def check_exposition(text: str) -> int:
    """Strict-parse the scrape and assert every declared metric family is
    present with a TYPE line (parse_exposition raises on malformed
    lines — that IS the format validation)."""
    parsed = parse_exposition(text)
    missing = [n for n in schema.metric_names()
               if n not in parsed["types"]]
    if missing:
        fail(f"/metrics missing declared families: {missing}")
    submitted = parsed["samples"].get(
        (schema.SERVICE_PREFIX + "submitted", ()))
    if not submitted or submitted < 1:
        fail(f"/metrics mid-stream shows submitted={submitted!r}, "
             f"expected >= 1 (the streaming request itself)")
    return len(parsed["types"])


def parse_sse(raw: bytes):
    head, _, payload = raw.partition(b"\r\n\r\n")
    events = []
    for block in payload.decode().strip().split("\n\n"):
        lines = dict(line.split(": ", 1) for line in block.splitlines())
        events.append((lines["event"], json.loads(lines["data"])))
    return head.decode(), events


def serve_command(device, *extra: str) -> list:
    """``python -m repro_torch.launch.serve --smoke`` with ``extra`` flags,
    on ``device`` (None: the launcher's default, the card)."""
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.serve",
           "--arch", "qwen3-0.6b", "--smoke", *extra]
    return cmd + (["--device", device] if device else [])


def child_env() -> dict:
    """The environment of a server child: this package importable."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=str(SRC) + (os.pathsep + path
                                                   if path else ""))


def start_server(cmd: list, fail_fn) -> tuple:
    """Start ``cmd`` (a server that prints its listen line), register it
    with the reaper and return (proc, port, boot seconds)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=child_env())
    _children.append(proc)
    port, t0 = None, time.monotonic()
    for line in proc.stdout:
        print(f"[server] {line.rstrip()}")
        m = re.search(r"listening on http://[\d.]+:(\d+)", line)
        if m:
            port = int(m.group(1))
            break
        if time.monotonic() - t0 > BOOT_TIMEOUT_S:
            fail_fn(f"no listen line within {BOOT_TIMEOUT_S}s", proc)
        if proc.poll() is not None:
            fail_fn(f"server exited {proc.returncode} before listening",
                    proc)
    if port is None:
        fail_fn("server stdout closed before the listen line", proc)
    return proc, port, time.monotonic() - t0


def parse_args(argv, doc):
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="the server's device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    proc, port, boot_s = start_server(
        serve_command(args.device, "--engine", "--http", "--port", "0",
                      "--queue-depth", "4"), fail)
    print(f"http_smoke: server up on port {port} ({boot_s:.0f}s boot)")

    body = json.dumps({"prompt_len": 12,
                       "max_new_tokens": NEW_TOKENS}).encode()
    raw, exposition = stream_and_scrape(port, (
        f"POST /v1/generate HTTP/1.1\r\nHost: s\r\n"
        f"Content-Length: {len(body)}\r\n\r\n").encode() + body,
        STREAM_TIMEOUT_S)
    if exposition is None:
        fail("stream finished without a mid-stream /metrics scrape", proc)
    n_families = check_exposition(exposition)
    print(f"http_smoke: mid-stream /metrics OK ({n_families} families, "
          f"all {len(schema.metric_names())} declared present)")
    head, events = parse_sse(raw)
    if not head.startswith("HTTP/1.1 200"):
        fail(f"status line: {head.splitlines()[0]!r}", proc)
    if "text/event-stream" not in head:
        fail(f"not an SSE response: {head!r}", proc)
    names = [n for n, _ in events]
    if names != ["token"] * NEW_TOKENS + ["done"]:
        fail(f"event framing {names} != {NEW_TOKENS}x token + done", proc)
    idxs = [d["index"] for n, d in events if n == "token"]
    if idxs != list(range(NEW_TOKENS)):
        fail(f"token indices {idxs} not 0..{NEW_TOKENS - 1}", proc)
    done = events[-1][1]
    if done["finish_reason"] != "length" or done["n_tokens"] != NEW_TOKENS:
        fail(f"done event {done} (want finish_reason=length "
             f"n_tokens={NEW_TOKENS})", proc)
    print(f"http_smoke: streamed {NEW_TOKENS} tokens + done "
          f"(ttft={done['ttft_ms']:.0f}ms latency={done['latency_ms']:.0f}ms)")

    raw = http_exchange(port, b"GET /healthz HTTP/1.1\r\nHost: s\r\n\r\n",
                        30)
    health = json.loads(raw.partition(b"\r\n\r\n")[2])
    if health["status"] != "ok" or health["service"]["completed"] != 1:
        fail(f"healthz {health}", proc)

    proc.send_signal(signal.SIGTERM)
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
    print("http_smoke: OK (SSE framing, healthz, SIGTERM drain, exit 0)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
