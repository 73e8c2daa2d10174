"""Async streaming service layer: the network front door over ``Engine``,
the port's copy of ``repro.serving.service``.

Two pieces:

``Service`` — the HTTP-free admission core, unit-testable without a socket:

  * a BOUNDED admission queue feeding ``Engine.submit`` with backpressure:
    at most ``n_slots + queue_depth`` requests are ever in flight
    (running + queued); ``submit`` returns a ``Ticket`` stream handle, or
    ``None`` when the bound is hit — the caller sheds (HTTP: 429 +
    Retry-After). The engine's own ``waiting`` list is therefore never
    longer than ``queue_depth``;
  * per-request DEADLINES (absolute, against an injectable ``clock``):
    an expired request is evicted wherever it lives — dropped from the
    queue, or ``Engine.cancel``-ed out of its slot MID-PREFILL, which in
    paged mode releases the slot's page references immediately — and its
    stream finishes with ``finish_reason="deadline"``;
  * DRAIN (``begin_drain``/``drain``): stop admitting (new submits shed
    with ``draining=True``; HTTP: 503) while every already-admitted
    request runs to completion — the SIGTERM path;
  * token streaming at host-sync granularity via ``Engine.on_token``:
    each emitted token is appended to its ticket and pushed through the
    ticket's ``sink`` callback, so a streaming transport sees tokens as
    the device produces them, not when the request finishes.

``HttpFrontDoor`` — a stdlib-asyncio HTTP/1.1 server (no third-party web
framework; the container has none) exposing the core as server-sent
events:

  POST /v1/generate   {"prompt": [ids] | "prompt_len": n,
                       "max_new_tokens": 16, "eos_id": null,
                       "deadline_s": null}
      200  text/event-stream; per token
             event: token
             data: {"index": i, "token": t}
           then exactly one
             event: done
             data: {"finish_reason": "length|eos|deadline|cancelled",
                    "n_tokens": n, "ttft_ms": ..., "latency_ms": ...}
      429  saturated, or deadline-infeasible under a warm admission
           controller (Retry-After header carries the honest estimate;
           body {"error": "saturated"|"infeasible", "retry_after_s": r})
      503  draining  (body {"error": "draining"})
      400  bad request (invalid JSON, bad/empty prompt, budget > max_seq,
           non-POST on a generate route)
      408  request not delivered within request_timeout_s (slow-loris)
      413  body exceeds max_body_bytes
     A fault-isolated request's stream terminates with ``event: error``
     (same payload shape as ``done``, finish_reason "error").
  GET /healthz | /stats
      200  {"status": "ok|draining", "slots_active": ..., "queued": ...,
            "service": {...}, "engine": {...}}
  GET /metrics
      200  text/plain Prometheus exposition: every Engine.stats /
           Service.stats key (declared in telemetry.schema) plus
           the per-step phase histograms and request TTFT/latency
           histograms — rendered on the pump thread via a ("metrics",
           fut) inbox op like every other service touch.

The engine is not thread-safe, and every CUDA call (an eager dispatch, a
graph capture or replay, a harvest) must come from one thread: a capture
in torch's default "global" mode fails if another thread makes an unsafe
CUDA call while it runs. So ALL service work runs on a dedicated pump
thread (``Service.step`` in a loop), which sets the engine's device before
its first step; the event loop touches no tensor and calls nothing in
``torch.cuda``, not even for ``/stats`` (the stats are plain Python
numbers, read on the pump). The asyncio side NEVER blocks on the pump's
lock — a handler that did would freeze the whole event loop for up to an
engine step (or a graph capture) per request, serializing every other
stream behind it. Instead
handlers post submit/cancel/health operations to a thread-safe inbox the
pump drains between steps (awaiting a future for the reply), and token
events flow back in per-step batches: sinks stage events on the pump
thread, the pump flushes each step's batch (events + replies) through ONE
``loop.call_soon_threadsafe``, and each stream coalesces its queued burst
into a single socket write. Tokens only materialize at host syncs, so the
batching adds no latency — it removes a per-token loop wakeup.
A client disconnect mid-stream cancels its request and frees the slot.
SIGTERM closes the listener, drains in-flight slots, then exits — see
``run_http``.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import os
import signal
import threading
import traceback
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch import telemetry
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.engine import FREE, Engine, Request, absorbable

Event = Tuple[Any, ...]   # ("token", index, token) | ("done", info_dict)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    queue_depth: int = 16           # admitted-but-unslotted bound; total
                                    # in-flight bound = n_slots + queue_depth
    default_deadline_s: Optional[float] = None   # per-request override wins
    retry_after_s: float = 0.25     # advertised on 429 responses
    telemetry: bool = True          # metrics registry + phase/latency
                                    # histograms (GET /metrics); off for the
                                    # bench overhead-control phase


class Ticket:
    """One admitted request's stream handle.

    ``tokens`` accumulates every emitted token (the identity surface the
    tests compare against ``Engine.run``); ``sink``, when set, receives
    ``("token", index, token)`` per token and one final ``("done", info)``.
    Timing fields use the service's clock."""

    def __init__(self, uid: int, deadline: Optional[float],
                 sink: Optional[Callable[[Event], None]], t_submit: float,
                 prompt_len: int = 0, max_new_tokens: int = 0):
        self.uid = uid
        self.deadline = deadline          # absolute clock value, or None
        self.sink = sink
        self.prompt_len = prompt_len      # work-remaining bookkeeping for
        self.max_new_tokens = max_new_tokens   # feasibility admission
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.t_submit = t_submit
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_submit


class Service:
    """Bounded-admission streaming service over one ``Engine``.

    The service owns the engine's ``on_token`` hook and its host-side
    lifecycle; callers drive it with ``submit``/``step`` (or ``drain``).
    NOT thread-safe — a multi-threaded transport must serialize access
    (``HttpFrontDoor`` gives its pump thread sole ownership and relays
    handler operations through an inbox)."""

    def __init__(self, engine: Engine, cfg: Optional[ServiceConfig] = None,
                 clock: Callable[[], float] = telemetry.default_clock,
                 admission: Optional[AdmissionController] = None):
        """``admission``: optional deadline-feasibility controller
        (serving/admission.py). When set, ``step`` feeds it the engine's
        per-step throughput and ``submit`` sheds deadlined requests the
        predictor deems infeasible — on top of (never instead of) the
        static ``n_slots + queue_depth`` hard cap."""
        self.engine = engine
        self.cfg = cfg or ServiceConfig()
        if self.cfg.queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        self.clock = clock
        self.admission = admission
        self.tickets: Dict[int, Ticket] = {}     # live (unfinished) only
        self.draining = False
        self.stats = {"submitted": 0, "completed": 0, "shed": 0,
                      "shed_infeasible": 0, "expired": 0, "cancelled": 0,
                      "faults": 0, "queue_peak": 0}
        # why the most recent submit was shed — the transport reads this
        # for its status code and (honest) Retry-After
        self.last_shed: Dict[str, Any] = {}
        engine.on_token = self._on_token
        # ONE clock drives the whole plane: lifecycle timestamps, span
        # recording, and phase attribution all read the service's
        # injectable clock once the engine is attached (tests inject a
        # fake clock here and everything downstream stays deterministic)
        engine.clock = self.clock
        self.registry: Optional[telemetry.MetricsRegistry] = None
        self._phase_hists: Dict[str, telemetry.Histogram] = {}
        self._ttft_hist: Optional[telemetry.Histogram] = None
        self._latency_hist: Optional[telemetry.Histogram] = None
        if self.cfg.telemetry:
            sch = telemetry.schema
            reg = self.registry = telemetry.MetricsRegistry()
            reg.register_stats(sch.SERVICE_PREFIX, self.stats,
                               sch.SERVICE_STATS)
            reg.register_stats(sch.ENGINE_PREFIX, engine.stats,
                               sch.ENGINE_STATS)
            for phase in sch.PHASES:
                self._phase_hists[phase] = reg.histogram(
                    sch.PHASE_HISTOGRAM,
                    "per-engine-step wall time by phase (seconds)",
                    buckets=sch.PHASE_BUCKETS_S, phase=phase)
            self._ttft_hist = reg.histogram(
                sch.TTFT_HISTOGRAM,
                "submit-to-first-token latency (seconds)",
                buckets=sch.LATENCY_BUCKETS_S)
            self._latency_hist = reg.histogram(
                sch.LATENCY_HISTOGRAM,
                "submit-to-finish latency (seconds)",
                buckets=sch.LATENCY_BUCKETS_S)

    def render_metrics(self) -> str:
        """Prometheus text exposition of every stat + histogram. Called
        on whatever thread owns the service (the pump, for the HTTP
        front door) — rendering reads the live dicts directly."""
        if self.registry is None:
            return "# telemetry disabled (ServiceConfig.telemetry=False)\n"
        return self.registry.render()

    # ------------------------------------------------------------- admission
    @property
    def load(self) -> int:
        """Admitted-but-unfinished requests (queued + running)."""
        return len(self.tickets)

    @property
    def capacity(self) -> int:
        return self.engine.n_slots + self.cfg.queue_depth

    @property
    def saturated(self) -> bool:
        return self.load >= self.capacity

    def _backlog_tokens(self) -> Tuple[int, int]:
        """(prefill, decode) tokens of work still owed to live tickets —
        the backlog a new admission queues behind. Prefill remaining is
        exact for slotted requests (the engine tracks ``prefill_done``)
        and the full prompt for queued ones."""
        prefilled = {}
        for s in self.engine.slots:
            if s.stage != FREE and s.result is not None:
                prefilled[s.result.uid] = s.prefill_done
        prefill = decode = 0
        for t in self.tickets.values():
            prefill += max(0, t.prompt_len - prefilled.get(t.uid, 0))
            decode += max(0, t.max_new_tokens - len(t.tokens))
        return prefill, decode

    def _retry_after(self) -> float:
        """Retry-After for a saturation shed: with a warm controller, the
        mean time for one in-flight request to drain (backlog work time /
        live requests) — a queue position should open around then; the
        static ``cfg.retry_after_s`` otherwise."""
        if self.admission is None or not self.admission.warm or not self.load:
            return self.cfg.retry_after_s
        pf, dec = self._backlog_tokens()
        return self.admission.clamp_retry(
            self.admission.work_s(pf, dec) / self.load)

    def submit(self, request: Request,
               deadline_s: Optional[float] = None,
               sink: Optional[Callable[[Event], None]] = None
               ) -> Optional[Ticket]:
        """Admit a request, or return None to shed — ``self.last_shed``
        tells the transport why (``draining`` / ``saturated`` /
        ``infeasible``) and what Retry-After to advertise. Invalid
        requests (empty prompt, budget > max_seq) raise ``ValueError``
        straight from ``Engine.submit``."""
        if self.draining:
            self.stats["shed"] += 1
            self.last_shed = {"reason": "draining", "retry_after_s": None}
            self._trace_shed("draining")
            return None
        if self.saturated:
            self.stats["shed"] += 1
            self.last_shed = {"reason": "saturated",
                              "retry_after_s": self._retry_after()}
            self._trace_shed("saturated")
            return None
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        prompt_len = len(request.prompt)
        if (deadline_s is not None and self.admission is not None
                and self.admission.warm):
            verdict = self.admission.feasible(
                prompt_len, request.max_new_tokens,
                self._backlog_tokens(), deadline_s)
            if not verdict.feasible:
                # shed NOW, at submit — before the request burns a queue
                # position and slot time only to die in the deadline sweep
                self.stats["shed"] += 1
                self.stats["shed_infeasible"] += 1
                self.last_shed = {"reason": "infeasible",
                                  "retry_after_s": verdict.retry_after_s,
                                  "predicted_s": verdict.predicted_s}
                self._trace_shed("infeasible")
                return None
        now = self.clock()
        uid = self.engine.submit(request)
        ticket = Ticket(uid,
                        None if deadline_s is None else now + deadline_s,
                        sink, now, prompt_len=prompt_len,
                        max_new_tokens=request.max_new_tokens)
        self.tickets[uid] = ticket
        self.stats["submitted"] += 1
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       len(self.engine.waiting))
        return ticket

    def _trace_shed(self, reason: str) -> None:
        """Record a shed on the engine's span recorder, if one is
        attached — sheds never reach the engine, so only the service can
        put them on the trace timeline."""
        if self.engine.tracer is not None:
            self.engine.tracer.shed(self.clock(), reason)

    # ------------------------------------------------------------- lifecycle
    def _on_token(self, uid: int, tok: int) -> None:
        t = self.tickets.get(uid)
        if t is None:        # a bare Engine.run on the side — not ours
            return
        if not t.tokens:
            t.t_first_token = self.clock()
        t.tokens.append(tok)
        if t.sink is not None:
            t.sink(("token", len(t.tokens) - 1, tok))

    def _finish(self, ticket: Ticket, reason: str, counter: str) -> None:
        ticket.finish_reason = reason
        ticket.t_finish = self.clock()
        self.tickets.pop(ticket.uid, None)
        self.stats[counter] += 1
        if self._latency_hist is not None:
            self._latency_hist.observe(ticket.latency_s)
            if ticket.ttft_s is not None:
                self._ttft_hist.observe(ticket.ttft_s)
        if ticket.sink is not None:
            lat = ticket.latency_s
            ttft = ticket.ttft_s
            ticket.sink(("done", {
                "finish_reason": reason,
                "n_tokens": len(ticket.tokens),
                "ttft_ms": None if ttft is None else ttft * 1e3,
                "latency_ms": None if lat is None else lat * 1e3,
            }))

    def cancel(self, uid: int) -> bool:
        """Abort a live request (client disconnect). Frees its slot/queue
        position (and pages, in paged mode) immediately."""
        ticket = self.tickets.get(uid)
        if ticket is None:
            return False
        self.engine.cancel(uid)
        self._finish(ticket, "cancelled", "cancelled")
        return True

    def expire_deadlines(self) -> int:
        """Evict every live request whose deadline has passed — queued OR
        mid-flight (mid-prefill eviction frees the slot's pages at once).
        Runs at the top of every ``step``; returns how many expired."""
        now = self.clock()
        expired = [t for t in self.tickets.values()
                   if t.deadline is not None and now > t.deadline]
        for t in expired:
            self.engine.cancel(t.uid)
            self._finish(t, "deadline", "expired")
        return len(expired)

    @property
    def has_work(self) -> bool:
        return self.engine.has_work

    def _fail_all(self) -> None:
        """Last-resort blast radius for an *unattributable* engine fault:
        cancel every live request (pages freed via ``Engine.cancel``) and
        finish their streams with ``error`` — the pump survives with a
        clean engine rather than dying mid-stream."""
        for t in list(self.tickets.values()):
            self.engine.cancel(t.uid)
            self._finish(t, "error", "faults")

    def step(self) -> int:
        """One service tick: deadline sweep, one engine tick, route
        finished results to their tickets. Returns finished count.

        Faults: the engine already scopes per-request failures (their
        results arrive with ``finish_reason="error"``); a fault it could
        not attribute that still leaves the engine able to serve
        (``engine.absorbable``) is absorbed here by failing every live
        request. A CUDA error, a kernel's failure or an ``AssertionError``
        propagates: the caller must see it. The engine's own per-step
        measurement (``Engine.last_step``) feeds BOTH the admission
        controller's EWMAs and the phase histograms — one clock read per
        step, two consumers, no service-side re-timing."""
        self.expire_deadlines()
        if not self.engine.has_work:
            return 0
        n = 0
        try:
            results = self.engine.step()
        except Exception as exc:
            if not absorbable(exc):
                raise
            self.stats["faults"] += 1
            self._fail_all()
            return 0
        last = self.engine.last_step
        if self.admission is not None:
            self.admission.observe_step(last)
        if self._phase_hists and last:
            for phase, dt in last["phases"].items():
                h = self._phase_hists.get(phase)
                if h is not None:
                    h.observe(dt)
        for res in results:
            ticket = self.tickets.get(res.uid)
            if ticket is not None:
                if res.finish_reason == "error":
                    self._finish(ticket, "error", "faults")
                else:
                    self._finish(ticket, res.finish_reason, "completed")
                n += 1
        return n

    def begin_drain(self) -> None:
        """Stop admitting; in-flight and queued requests keep running."""
        self.draining = True

    def drain(self) -> None:
        """``begin_drain`` + run every admitted request to completion
        (deadline expiry still applies — a drain can never hang on a
        deadlined request)."""
        self.begin_drain()
        while self.has_work:
            self.step()


# ---------------------------------------------------------------- HTTP layer
_SSE_HEADERS = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n"
                b"X-Accel-Buffering: no\r\n"
                b"Connection: close\r\n\r\n")


def sse_event(name: str, data: dict) -> bytes:
    return (f"event: {name}\ndata: {json.dumps(data)}\n\n").encode()


class _BodyTooLarge(Exception):
    """Request body exceeds the front door's cap (maps to 413)."""

    def __init__(self, n: int):
        super().__init__(f"body too large: {n} bytes")
        self.n = n


def _plain_response(status: str, body: dict,
                    extra_headers: Tuple[str, ...] = ()) -> bytes:
    payload = json.dumps(body).encode()
    head = [f"HTTP/1.1 {status}",
            "Content-Type: application/json",
            f"Content-Length: {len(payload)}",
            "Connection: close", *extra_headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + payload


def _text_response(status: str, text: str, content_type: str) -> bytes:
    payload = text.encode()
    head = [f"HTTP/1.1 {status}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(payload)}",
            "Connection: close"]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + payload


# what GET /metrics advertises — the version-tagged Prometheus text format
_EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class HttpFrontDoor:
    """asyncio HTTP/1.1 + SSE transport over a ``Service``.

    Single-owner concurrency: the pump thread owns ALL service/engine
    access (``self.lock`` guards it only against the shutdown path).
    Handler coroutines never touch the service directly — they post
    ``("submit", ...)``/``("cancel", ...)``/``("health", ...)`` operations
    to ``self._inbox`` and await a future; the pump drains the inbox
    between engine steps, so the event loop is never blocked behind a
    multi-millisecond step (or a graph capture) and admission
    decisions stay strictly serialized with ticks. ``start()`` binds the
    listener (``port=0`` picks a free port, re-read from ``self.port``)
    and starts the pump; ``stop()`` closes the listener, optionally
    drains, and joins the pump."""

    def __init__(self, service: Service, host: str = "127.0.0.1",
                 port: int = 8080, pump_idle_s: float = 0.001,
                 log: Callable[[str], None] = lambda s: None,
                 max_body_bytes: int = 1 << 20,
                 request_timeout_s: float = 10.0,
                 watchdog_s: Optional[float] = None,
                 on_wedged: Optional[Callable[[str], None]] = None,
                 pump_context=None):
        """``max_body_bytes`` caps request bodies (413 beyond it);
        ``request_timeout_s`` bounds how long a client may take to
        deliver a full request (408 beyond it — the slow-loris defense).
        ``watchdog_s`` arms the pump watchdog: if the pump thread makes
        no progress for that long (a wedged engine step: a hung kernel,
        a deadlock), ``on_wedged`` fires; the default logs and
        ``os._exit(2)``s, because a wedged engine cannot be drained and a
        clean nonzero exit beats a silent hang (tests inject a recorder
        instead). ``pump_context``, a context manager, is entered on the
        pump thread around its loop (``serve --profile-dir`` runs its
        profiler there, where the engine's work runs)."""
        self.service = service
        self.pump_context = pump_context or contextlib.nullcontext()
        self.host = host
        self.port = port
        self.pump_idle_s = pump_idle_s
        self.log = log
        self.max_body_bytes = max_body_bytes
        self.request_timeout_s = request_timeout_s
        self.watchdog_s = watchdog_s
        self.on_wedged = on_wedged or self._exit_wedged
        # the heartbeat measures REAL wall time even under an injected test
        # clock: the watchdog exists to catch a wedged pump thread, and a
        # frozen fake clock must not mask one. telemetry.wall_clock is the
        # one sanctioned raw-clock read in serving (see its docstring).
        self._beat = telemetry.wall_clock()
        self.lock = threading.Lock()
        self._stop_pump = threading.Event()
        self._kick = threading.Event()       # wakes an idle-parked pump
        self._pump_thread: Optional[threading.Thread] = None
        self.pump_error: Optional[BaseException] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._active_streams = 0
        # handler -> pump operations; deque appends/pops are atomic so no
        # extra lock is needed on the hot path
        self._inbox: Deque[Tuple[Any, ...]] = collections.deque()
        # pump -> loop: events staged by sinks (grouped per stream queue),
        # flushed in ONE call_soon_threadsafe per engine step — a decode
        # scan emits decode_steps x n_slots tokens per host sync, and
        # waking the loop per token (a self-pipe write each) costs more
        # than the tokens; grouping here also makes the loop-side queue
        # traffic per-stream-per-step instead of per-token
        self._staged: Dict[asyncio.Queue, List[Event]] = {}
        self._replies: List[Tuple[asyncio.Future, Any]] = []
        # prompt_len synthesis (curl/load-tool convenience, mirrors the
        # JSONL trace loader's contract)
        self._rng = np.random.RandomState(0)

    # -------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_thread = threading.Thread(target=self._pump, daemon=True,
                                             name="engine-pump")
        self._pump_thread.start()
        if self.watchdog_s:
            self._watchdog_thread = threading.Thread(
                target=self._watch, daemon=True, name="pump-watchdog")
            self._watchdog_thread.start()

    def _pump(self) -> None:
        """Engine thread: drain handler operations, step whenever there is
        work, park briefly when idle (a ``_kick`` wakes it early). Serving
        the inbox and stepping on one thread keeps submit/cancel strictly
        between ticks — the same interleaving the sync tests drive by
        hand. Each iteration flushes everything it staged (token events +
        operation replies) to the event loop in one batch.

        A fault that escapes ``Service.step`` (a CUDA error, a kernel's
        failure, an ``AssertionError``) ends the pump: it is kept in
        ``pump_error`` and escalated through ``on_wedged``, whose default
        exits 2, since no thread may touch the engine any more."""
        try:
            dev = self.service.engine.device
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            with self.pump_context:
                self._pump_loop()
        except Exception as exc:
            self.pump_error = exc
            self._stop_pump.set()
            self.on_wedged(f"[http] PUMP FAILED: the engine raised "
                           f"{type(exc).__name__}; no thread may serve "
                           f"it now, exiting 2\n{traceback.format_exc()}")

    def _pump_loop(self) -> None:
        while not self._stop_pump.is_set():
            # wall time on purpose — see _beat in __init__
            self._beat = telemetry.wall_clock()
            with self.lock:
                self._serve_inbox()
                busy = self.service.has_work
                if busy:
                    self.service.step()
                staged, self._staged = self._staged, {}
                replies, self._replies = self._replies, []
            if staged or replies:
                self._loop.call_soon_threadsafe(self._flush, staged,
                                                replies)
            if not busy:
                self._kick.wait(self.pump_idle_s)
                self._kick.clear()

    def _exit_wedged(self, msg: str) -> None:
        """Default wedged-pump escalation: a hung engine step cannot be
        drained (the pump owns the only thread allowed to touch it), so
        log loudly and exit with a clean nonzero status — supervisors
        restart on exit codes, not on silence."""
        self.log(msg)
        os._exit(2)

    def _watch(self) -> None:
        """Watchdog thread: the pump stamps ``_beat`` every iteration
        (idle parks are sub-millisecond), so a stale heartbeat means one
        engine step / inbox op has been stuck for ``watchdog_s``."""
        period = min(max(self.watchdog_s / 4.0, 0.01), 1.0)
        while not self._stop_pump.wait(period):
            # wall time on purpose — see _beat in __init__
            stale = telemetry.wall_clock() - self._beat
            if stale > self.watchdog_s:
                self.on_wedged(
                    f"[http] WATCHDOG: pump made no progress for "
                    f"{stale:.1f}s (> {self.watchdog_s:g}s) — engine step "
                    f"wedged; cannot drain, exiting 2")
                return

    def _serve_inbox(self) -> None:
        """Apply queued handler operations (pump thread, lock held)."""
        svc = self.service
        while self._inbox:
            op = self._inbox.popleft()
            if op[0] == "submit":
                _, req, deadline_s, sink, fut = op
                try:
                    ticket = svc.submit(req, deadline_s=deadline_s,
                                        sink=sink)
                    res: Any = (ticket, None if ticket is not None
                                else dict(svc.last_shed))
                except ValueError as e:
                    res = e
                self._replies.append((fut, res))
            elif op[0] == "cancel":
                svc.cancel(op[1])
            elif op[0] == "health":
                self._replies.append((op[1], self._snapshot()))
            elif op[0] == "metrics":
                # rendered HERE so the exposition is a consistent
                # between-steps snapshot — handlers never read live dicts
                self._replies.append((op[1], svc.render_metrics()))
            elif op[0] == "drain":
                svc.begin_drain()
                self._replies.append((op[1], True))
            else:                                    # ("idle", fut)
                self._replies.append((op[1], not svc.has_work))

    @staticmethod
    def _flush(staged: Dict[asyncio.Queue, List[Event]],
               replies: List[Tuple[asyncio.Future, Any]]) -> None:
        for queue, evs in staged.items():
            queue.put_nowait(evs)              # one item per stream per step
        for fut, value in replies:
            if not fut.done():
                if isinstance(value, Exception):
                    fut.set_exception(value)
                else:
                    fut.set_result(value)

    async def _ask(self, op: Tuple[Any, ...]) -> Any:
        """Post an operation needing a reply; the last element must be a
        fresh future from this loop."""
        self._inbox.append(op)
        self._kick.set()
        return await op[-1]

    async def stop(self, drain: bool = True) -> None:
        """Close the listener; with ``drain`` run every admitted request to
        completion (the pump keeps stepping) and let open streams flush
        their final events before the pump stops. Goes through the inbox
        like every other service touch, so the loop stays responsive (and
        keeps delivering final events) throughout shutdown."""
        await self._ask(("drain", self._loop.create_future()))
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if drain:
            while True:
                idle = await self._ask(("idle", self._loop.create_future()))
                if idle and self._active_streams == 0:
                    break
                await asyncio.sleep(0.002)
        self._stop_pump.set()
        self._kick.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=10)

    # --------------------------------------------------------------- handler
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._active_streams += 1
        try:
            try:
                method, path, body = await asyncio.wait_for(
                    self._read_request(reader), self.request_timeout_s)
            except asyncio.TimeoutError:
                # slow-loris: the client dribbled bytes slower than the
                # request timeout — answer and hang up, never touching
                # the pump
                writer.write(_plain_response(
                    "408 Request Timeout",
                    {"error": "request not received in "
                              f"{self.request_timeout_s:g}s"}))
                return
            except _BodyTooLarge as e:
                writer.write(_plain_response(
                    "413 Payload Too Large",
                    {"error": f"body of {e.n} bytes exceeds "
                              f"{self.max_body_bytes}"}))
                return
            except (asyncio.IncompleteReadError, ValueError):
                writer.write(_plain_response(
                    "400 Bad Request", {"error": "malformed request"}))
                return
            if method == "GET" and path in ("/healthz", "/stats"):
                writer.write(_plain_response("200 OK", await self._health()))
            elif method == "GET" and path == "/metrics":
                writer.write(_text_response("200 OK", await self._metrics(),
                                            _EXPOSITION_CONTENT_TYPE))
            elif path in ("/v1/generate", "/generate"):
                if method != "POST":
                    writer.write(_plain_response(
                        "400 Bad Request",
                        {"error": f"use POST for {path}, not {method}"}))
                else:
                    await self._generate(writer, body)
            else:
                writer.write(_plain_response(
                    "404 Not Found", {"error": f"no route {method} {path}"}))
        finally:
            self._active_streams -= 1
            try:
                await writer.drain()
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
        parts = line.split(" ")
        if len(parts) != 3:
            raise ValueError(f"bad request line {line!r}")
        method, path = parts[0], parts[1]
        headers = {}
        while True:
            h = await reader.readline()   # StreamReader's own line limit
            if h in (b"\r\n", b"\n", b""):     # turns absurd headers into
                break                          # ValueError -> 400
            if len(headers) > 100:
                raise ValueError("too many headers")
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        if n > self.max_body_bytes:
            raise _BodyTooLarge(n)             # -> 413, body never read
        body = await reader.readexactly(n) if n else b""
        return method, path, body

    def _snapshot(self) -> dict:
        """Health/stats payload (pump thread, lock held)."""
        svc = self.service
        return {"status": "draining" if svc.draining else "ok",
                "slots_active": svc.engine.n_active,
                "queued": len(svc.engine.waiting),
                "capacity": svc.capacity,
                "service": dict(svc.stats),
                "engine": dict(svc.engine.stats)}

    async def _health(self) -> dict:
        return await self._ask(("health", self._loop.create_future()))

    async def _metrics(self) -> str:
        return await self._ask(("metrics", self._loop.create_future()))

    def _parse_request(self, body: bytes) -> Tuple[Request, Optional[float]]:
        """Parse + validate a generate body; every rejection raises here,
        BEFORE the pump is involved — a malformed request must cost the
        event loop a 400, never an engine exception."""
        max_seq = self.service.engine.max_seq
        d = json.loads(body.decode() or "{}")
        if not isinstance(d, dict):
            raise ValueError("body must be a JSON object")
        if "prompt" in d:
            prompt = d["prompt"]
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) and not isinstance(t, bool)
                               for t in prompt)):
                raise ValueError("'prompt' must be a non-empty list of "
                                 "token ids")
        elif "prompt_len" in d:
            n = int(d["prompt_len"])
            if not (1 <= n <= max_seq):
                raise ValueError(f"prompt_len must be in [1, {max_seq}]")
            vocab = self.service.engine.cfg.vocab_size
            prompt = self._rng.randint(0, vocab, n).tolist()
        else:
            raise ValueError("body needs 'prompt' (token ids) or "
                             "'prompt_len'")
        req = Request(prompt=prompt,
                      max_new_tokens=int(d.get("max_new_tokens", 16)),
                      eos_id=d.get("eos_id"))
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + req.max_new_tokens > max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq={max_seq}")
        deadline_s = d.get("deadline_s")
        return req, (None if deadline_s is None else float(deadline_s))

    async def _generate(self, writer: asyncio.StreamWriter,
                        body: bytes) -> None:
        try:
            req, deadline_s = self._parse_request(body)
        except (json.JSONDecodeError, ValueError, TypeError, KeyError) as e:
            writer.write(_plain_response("400 Bad Request",
                                         {"error": str(e)}))
            return
        queue: asyncio.Queue = asyncio.Queue()

        def sink(ev: Event) -> None:
            # runs on the pump thread mid-step; the pump flushes the batch
            # to the loop after the step (it swaps in a fresh dict each
            # step, so always dereference self._staged)
            self._staged.setdefault(queue, []).append(ev)

        try:
            ticket, shed = await self._ask(
                ("submit", req, deadline_s, sink,
                 self._loop.create_future()))
        except ValueError as e:
            writer.write(_plain_response("400 Bad Request",
                                         {"error": str(e)}))
            return
        if ticket is None:
            reason = (shed or {}).get("reason", "saturated")
            if reason == "draining":
                writer.write(_plain_response(
                    "503 Service Unavailable", {"error": "draining"}))
            else:
                # saturated or deadline-infeasible; Retry-After is the
                # service's honest estimate when the admission controller
                # is warm, its static default otherwise
                retry = (shed or {}).get("retry_after_s")
                if retry is None:
                    retry = self.service.cfg.retry_after_s
                body_out = {"error": reason, "retry_after_s": retry}
                if "predicted_s" in (shed or {}):
                    body_out["predicted_s"] = round(shed["predicted_s"], 4)
                writer.write(_plain_response(
                    "429 Too Many Requests", body_out,
                    extra_headers=(f"Retry-After: {retry:g}",)))
            return
        writer.write(_SSE_HEADERS)
        try:
            await writer.drain()
            while True:
                # each queue item is one step's event batch for this
                # stream (up to decode_steps tokens); coalesce any backlog
                # into a single write + drain
                burst = list(await queue.get())
                while not queue.empty():
                    burst.extend(queue.get_nowait())
                out = bytearray()
                finished = False
                for ev in burst:
                    if ev[0] == "token":
                        # hot path: bytes %-format, no json round-trip
                        out += (b'event: token\n'
                                b'data: {"index": %d, "token": %d}\n\n'
                                % (ev[1], int(ev[2])))
                    else:
                        # a fault-isolated request ends its stream with
                        # event: error instead of done (same payload shape)
                        name = ("error"
                                if ev[1].get("finish_reason") == "error"
                                else "done")
                        out += sse_event(name, ev[1])
                        finished = True
                writer.write(bytes(out))
                await writer.drain()
                if finished:
                    return
        except (ConnectionResetError, BrokenPipeError, OSError):
            # client went away mid-stream: free the slot immediately
            self._inbox.append(("cancel", ticket.uid))
            self._kick.set()


def run_http(service: Service, host: str = "127.0.0.1", port: int = 8080,
             log: Callable[[str], None] = print,
             watchdog_s: Optional[float] = None,
             pump_context=None) -> None:
    """Blocking entrypoint for ``serve --http``: listen until SIGTERM (or
    SIGINT), then drain in-flight slots before returning — the graceful
    shutdown contract ``chip_smoke.py`` asserts. ``watchdog_s`` arms the
    pump watchdog (a wedged engine step exits 2 instead of hanging);
    ``pump_context`` is entered on the pump thread (``HttpFrontDoor``)."""
    door = HttpFrontDoor(service, host=host, port=port, log=log,
                         watchdog_s=watchdog_s, pump_context=pump_context)

    async def main() -> None:
        await door.start()
        eng = service.engine
        log(f"[http] listening on http://{door.host}:{door.port} "
            f"(slots={eng.n_slots}, queue_depth={service.cfg.queue_depth}, "
            f"deadline_s={service.cfg.default_deadline_s})")
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        log("[http] shutdown signal: closing listener, draining "
            f"{service.load} in-flight request(s)")
        await door.stop(drain=True)
        log(f"[http] drained cleanly: served {service.stats['completed']} "
            f"requests ({service.stats['shed']} shed, "
            f"{service.stats['expired']} deadline-expired)")

    asyncio.run(main())
