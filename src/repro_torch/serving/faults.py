"""Deterministic fault injection for the serving stack, the port's copy of
``repro.serving.faults``.

Every injector is counted or seeded, so a chaos run that trips an
invariant can be replayed exactly: "the 3rd page allocation fails", "the
2nd decode dispatch raises", "this client vanishes after 4 tokens", never
"fail randomly at 1 %".

Engine-side injectors wrap a live ``Engine`` in place and return a
``FaultHandle`` whose ``restore()`` puts the original back:

  inject_alloc_failure(engine, at=N)   the Nth ``PageAllocator.alloc``
                                       call raises ``MemoryError``: arena
                                       exhaustion at a chosen moment
                                       (admission, growth, copy-on-write)
  inject_decode_fault(engine, at=N)    the Nth decode dispatch (kinds
                                       ``decode`` and ``spec``) raises
                                       ``InjectedFault``
  inject_prefill_fault(engine, at=N)   the same for prefill chunks (kinds
                                       ``prefill`` and ``spec_prefill``)

The reference's injectors replace its jitted callables; the port's engine
has none, so a dispatch injector wraps ``engine.graphs.run``, where every
dispatch enqueues its device work (``serving.dispatch``), and counts the
kinds it targets. The fault fires before anything is launched, whether the
dispatch would have run eagerly, been captured or been replayed: the
pools are untouched, which exercises the engine's per-request isolation. A
fault part way through a dispatch is a test's to raise (from inside the
model, say), and the engine's position repair covers it.

Client-side chaos (plain blocking sockets, so a subprocess smoke and the
in-process tests share one implementation):

  storm_deadlines(seed, n, lo_s, hi_s)   seeded deadline storm
  http_disconnect_mid_stream(...)        start an SSE stream, vanish after
                                         N token events
  http_slow_loris(...)                   dribble a partial request slower
                                         than the server's read timeout
  http_malformed(...)                    raw bytes on the socket, return
                                         the status line the server sent
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct
from typing import Callable, List, Optional

import numpy as np

DECODE_KINDS = ("decode", "spec")
PREFILL_KINDS = ("prefill", "spec_prefill")


class InjectedFault(RuntimeError):
    """Raised by counted injectors: distinguishable from organic faults."""


@dataclasses.dataclass
class FaultHandle:
    """Live injector state: ``calls`` counts invocations seen, ``fired``
    how many times the fault actually raised. ``restore()`` reinstalls
    the wrapped original (idempotent)."""
    kind: str
    at: int
    times: int
    calls: int = 0
    fired: int = 0
    _restore: Optional[Callable[[], None]] = None

    def restore(self) -> None:
        if self._restore is not None:
            self._restore()
            self._restore = None

    def _count(self) -> bool:
        """Count one invocation; True when it is one that must raise
        (invocations ``at .. at + times - 1``, 1-based)."""
        self.calls += 1
        if self.at <= self.calls < self.at + self.times:
            self.fired += 1
            return True
        return False


def inject_alloc_failure(engine, at: int = 1, times: int = 1) -> FaultHandle:
    """Force ``MemoryError`` on the Nth (1-based) ``alloc.alloc`` call.

    The engine's ``_alloc_pages`` retries after evicting a prefix-cache
    entry, so with a warm prefix cache one injected failure can be absorbed
    by an eviction; pass ``times`` > 1 (or run with the prefix cache off)
    to make the fault surface."""
    if engine.alloc is None:
        raise ValueError("alloc injection needs a paged engine")
    h = FaultHandle("alloc", at, times)
    alloc = engine.alloc
    orig = alloc.alloc

    def counted(*args, **kwargs):
        if h._count():
            raise MemoryError(f"injected: alloc #{h.calls} denied")
        return orig(*args, **kwargs)

    alloc.alloc = counted

    def _restore():
        alloc.alloc = orig
    h._restore = _restore
    return h


def _inject_dispatch(engine, kinds, name: str, at: int, times: int,
                     exc) -> FaultHandle:
    h = FaultHandle(name, at, times)
    graphs = engine.graphs
    orig = graphs.run

    def run(kind, key, body):
        if kind in kinds and h._count():
            raise exc(f"injected: {name} dispatch #{h.calls} ({kind} "
                      f"{key!r})")
        return orig(kind, key, body)

    graphs.run = run

    def _restore():
        graphs.run = orig
    h._restore = _restore
    return h


def inject_decode_fault(engine, at: int = 1, times: int = 1,
                        exc=InjectedFault) -> FaultHandle:
    """The Nth decode dispatch (plain or speculative) raises before it
    launches anything."""
    return _inject_dispatch(engine, DECODE_KINDS, "decode", at, times, exc)


def inject_prefill_fault(engine, at: int = 1, times: int = 1,
                         exc=InjectedFault) -> FaultHandle:
    """The Nth prefill chunk (plain or speculative) raises before it
    launches anything."""
    return _inject_dispatch(engine, PREFILL_KINDS, "prefill", at, times,
                            exc)


# ------------------------------------------------------------- deadline storm
def storm_deadlines(seed: int, n: int, lo_s: float, hi_s: float
                    ) -> List[float]:
    """Seeded per-request deadlines for a deadline storm: uniform in
    ``[lo_s, hi_s)``, reproducible by seed."""
    rng = np.random.RandomState(seed)
    return [float(d) for d in rng.uniform(lo_s, hi_s, size=n)]


# --------------------------------------------------------- client-side chaos
def _connect(host: str, port: int, timeout_s: float) -> socket.socket:
    s = socket.create_connection((host, port), timeout=timeout_s)
    s.settimeout(timeout_s)
    return s


def _post_bytes(path: str, body: bytes) -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def http_malformed(host: str, port: int, payload: bytes,
                   timeout_s: float = 10.0) -> str:
    """Write raw ``payload`` to the server, return the status line it
    answered with ('' if it closed without answering)."""
    with _connect(host, port, timeout_s) as s:
        s.sendall(payload)
        try:
            s.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        try:
            head = s.recv(4096)
        except (socket.timeout, OSError):
            return ""
    return head.split(b"\r\n", 1)[0].decode("latin-1", "replace")


def http_slow_loris(host: str, port: int, hold_s: float,
                    timeout_s: float = 30.0) -> str:
    """Dribble a partial request line, then stall for ``hold_s``. A
    hardened server times the read out (408) or closes; returns the
    status line ('' for a silent close). Never wedges the pump: the read
    happens on the event loop, not the engine thread."""
    with _connect(host, port, timeout_s) as s:
        s.sendall(b"POST /v1/gen")          # incomplete request line
        try:
            s.settimeout(hold_s + timeout_s)
            head = s.recv(4096)             # server acts first: 408/close
        except (socket.timeout, OSError):
            return ""
    return head.split(b"\r\n", 1)[0].decode("latin-1", "replace")


def http_disconnect_mid_stream(host: str, port: int, body: dict,
                               after_tokens: int = 1,
                               timeout_s: float = 60.0) -> int:
    """POST /v1/generate, read until ``after_tokens`` ``event: token``
    frames arrived, then vanish (abortive close, RST rather than FIN, so
    the server sees a reset on its next write). Returns tokens seen."""
    raw = _post_bytes("/v1/generate", json.dumps(body).encode())
    s = _connect(host, port, timeout_s)
    try:
        s.sendall(raw)
        seen, buf = 0, b""
        while seen < after_tokens:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
            seen = buf.count(b"event: token")
        # SO_LINGER(0): close sends RST at once, the bluntest disconnect
        # a client can produce
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        return seen
    finally:
        s.close()
