"""The port's service plane on the CPU (plain versions of the kernels):
the engine's fault boundary, ``cancel``, ``last_step`` and spans, the
bounded-admission ``Service``, the HTTP/SSE ``HttpFrontDoor`` and
``serve --engine --http``, modelled on the JAX package's
``tests/test_service.py`` and the engine cases of ``tests/test_telemetry.py``.

The two reference fault scenarios run in both packages on the same weights
and must end alike (finish reasons, fault and page counts, post-fault
tokens up to the reference's exact ties, ROADMAP C2). The port's own
invariants: a fault fails only the requests its phase was working on, the
survivors equal serial decode, pages return to the baseline, and every
surviving slot's device position equals its host mirror in both pools,
also after a fault part way through a speculative dispatch that had parked
it; CUDA errors, kernel failures and ``AssertionError`` propagate."""
import asyncio
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:      # bare container: skip property tests
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs, telemetry  # noqa: E402
from repro_torch.compress import quantize_lm_params  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.serving import (Engine, HttpFrontDoor, Request,  # noqa: E402
                                 SchedulerConfig, Service, ServiceConfig,
                                 faults, serial_decode)
from repro_torch.serving.engine import DECODE, FREE, PREFILL  # noqa: E402
from repro_torch.serving.scheduler import Action, Scheduler  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-0.6b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_SEQ = 64
schema = telemetry.schema


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers would
    oversubscribe the cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config(ARCH)
    parent = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, parent, quantize_lm_params(parent)


@pytest.fixture(scope="module")
def both():
    """The JAX package's smoke model and the same weights in the port."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, configs.get_smoke_config(ARCH), tp


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def _fake_clock():
    now = [0.0]
    return now, (lambda: now[0])


def _ticking_clock(dt=1e-4):
    now = [0.0]

    def clk():
        now[0] += dt
        return now[0]
    return now, clk


# ------------------------------------------------------ against the reference
def _reference_logits(jp, jcfg, prompt, tokens):
    """The JAX package's serial logits for the token after prompt+tokens."""
    ctx = default_ctx()
    step = jax.jit(lambda p, st_, t: jlm.decode_step(p, jcfg, st_, t, ctx))
    state = jlm.init_decode_state(jcfg, 1, MAX_SEQ, ctx, params=jp)
    logits, state = step(jp, state, np.asarray([prompt], np.int32))
    for tok in tokens:
        logits, state = step(jp, state, np.asarray([[tok]], np.int32))
    return np.asarray(logits[0, -1])[:jcfg.vocab_size]


def _agree(got, want, jp, jcfg, prompt):
    """The port's tokens equal the reference's, up to an exact tie in the
    reference's bf16 logits where they first differ (ROADMAP C2)."""
    assert len(got) == len(want)
    n = next((t for t in range(len(want)) if got[t] != want[t]), len(want))
    if n < len(want):
        ref = _reference_logits(jp, jcfg, prompt, want[:n])
        assert ref[got[n]] == ref.max(), (n, got, want)


def _decode_fault_scenario(pkg, fmod, params, cfg, **kw):
    """``tests/test_service.py::test_decode_fault_errors_requests_pump_
    survives`` (:228), for either package."""
    eng = pkg.Engine(params, cfg, n_slots=2, max_seq=MAX_SEQ,
                     sched=pkg.SchedulerConfig(prefill_chunk=8),
                     page_size=8, prefix_cache=False, **kw)
    prompts = _prompts(cfg, [7, 9, 11], seed=11)
    ref = eng.run([pkg.Request(prompt=prompts[2], max_new_tokens=4)])[0]
    svc = pkg.Service(eng, pkg.ServiceConfig(queue_depth=4))
    events = []
    h = fmod.inject_decode_fault(eng, at=1)
    try:
        a = svc.submit(pkg.Request(prompt=prompts[0], max_new_tokens=4),
                       sink=events.append)
        b = svc.submit(pkg.Request(prompt=prompts[1], max_new_tokens=4))
        while svc.has_work:
            svc.step()
    finally:
        h.restore()
    out = {"fired": h.fired, "reasons": (a.finish_reason, b.finish_reason),
           "last_event": (events[-1][0], events[-1][1]["finish_reason"]),
           "faults": (svc.stats["faults"], eng.stats["faults"]),
           "pages": eng.alloc.pages_in_use}
    eng.alloc.check()
    c = svc.submit(pkg.Request(prompt=prompts[2], max_new_tokens=4))
    while svc.has_work:
        svc.step()
    out.update(c_reason=c.finish_reason, pages_after=eng.alloc.pages_in_use)
    eng.alloc.check()
    return out, (prompts[2], c.tokens, ref.tokens)


def _alloc_fault_scenario(pkg, fmod, params, cfg, **kw):
    """``tests/test_service.py::test_alloc_fault_fails_only_that_
    admission`` (:266), for either package."""
    eng = pkg.Engine(params, cfg, n_slots=2, max_seq=MAX_SEQ,
                     sched=pkg.SchedulerConfig(prefill_chunk=8),
                     page_size=8, prefix_cache=False, **kw)
    prompts = _prompts(cfg, [9, 9], seed=13)
    svc = pkg.Service(eng, pkg.ServiceConfig(queue_depth=4))
    h = fmod.inject_alloc_failure(eng, at=1)
    try:
        a = svc.submit(pkg.Request(prompt=prompts[0], max_new_tokens=3))
        while svc.has_work:
            svc.step()
    finally:
        h.restore()
    out = {"fired": h.fired, "a": a.finish_reason,
           "faults": (svc.stats["faults"], eng.stats["faults"])}
    b = svc.submit(pkg.Request(prompt=prompts[1], max_new_tokens=3))
    while svc.has_work:
        svc.step()
    out.update(b=b.finish_reason, pages=eng.alloc.pages_in_use)
    eng.alloc.check()
    return out, (prompts[1], b.tokens)


def test_decode_fault_errors_requests_pump_survives(both):
    """The reference's scenario in both packages: the first decode dispatch
    faults, exactly its two requests end in ``error`` (the stream's last
    event says so), both counted, no page outlives them, and a request
    after the fault completes with the tokens of a clean run."""
    jcfg, jp, cfg, tp = both
    want, (jprompt, jtoks, jref) = _decode_fault_scenario(jserving, jfaults,
                                                          jp, jcfg)
    got, (prompt, toks, ref) = _decode_fault_scenario(serving, faults, tp,
                                                      cfg, device="cpu")
    assert got == want
    assert got["reasons"] == ("error", "error") and got["faults"] == (2, 2)
    assert got["pages"] == 0 and got["c_reason"] == "length"
    assert toks == ref                           # within the port: exact
    _agree(toks, jtoks, jp, jcfg, prompt)


def test_alloc_fault_fails_only_that_admission(both):
    jcfg, jp, cfg, tp = both
    want, (jprompt, jtoks) = _alloc_fault_scenario(jserving, jfaults, jp,
                                                   jcfg)
    got, (prompt, toks) = _alloc_fault_scenario(serving, faults, tp, cfg,
                                                device="cpu")
    assert got == want
    assert got["a"] == "error" and got["faults"] == (1, 1)
    assert got["b"] == "length" and got["pages"] == 0
    _agree(toks, jtoks, jp, jcfg, prompt)


def test_streamed_tokens_equal_engine_run_and_the_reference(both):
    """Tokens streamed through the port's ``Service`` equal ``Engine.run``
    of the same requests on the same engine, one event a token in order
    then exactly one ``done``; and equal the reference ``Service``'s
    streams (up to C2's exact ties)."""
    jcfg, jp, cfg, tp = both
    prompts = _prompts(cfg, [5, 9, 13], seed=7)
    streams = {}
    for name, pkg, params, kw in (("ref", jserving, jp, {}),
                                  ("port", serving, tp, {"device": "cpu"})):
        eng = pkg.Engine(params, jcfg if name == "ref" else cfg, n_slots=2,
                         max_seq=MAX_SEQ,
                         sched=pkg.SchedulerConfig(prefill_chunk=8), **kw)
        svc = pkg.Service(eng, pkg.ServiceConfig(queue_depth=4))
        events = {i: [] for i in range(len(prompts))}
        tickets = [svc.submit(pkg.Request(prompt=p, max_new_tokens=6),
                              sink=events[i].append)
                   for i, p in enumerate(prompts)]
        while svc.has_work:
            svc.step()
        run = eng.run([pkg.Request(prompt=p, max_new_tokens=6)
                       for p in prompts])
        for i, t in enumerate(tickets):
            assert t.tokens == run[i].tokens
            toks = [e for e in events[i] if e[0] == "token"]
            dones = [e for e in events[i] if e[0] == "done"]
            assert [e[1] for e in toks] == list(range(6))
            assert [e[2] for e in toks] == t.tokens
            assert len(dones) == 1 and events[i][-1] is dones[0]
            assert dones[0][1]["finish_reason"] == "length"
        streams[name] = [t.tokens for t in tickets]
    for i, prompt in enumerate(prompts):
        _agree(streams["port"][i], streams["ref"][i], jp, jcfg, prompt)


# ----------------------------------------------------- the engine's boundary
LAYOUTS = ("contiguous", "paged", "speculative", "speculative paged")


def _engine(setup, layout, n_slots=3, chunk=5, steps=3, **kw):
    """An engine of the layout and its serial oracle. Plain: the INT8 PTQ
    model with INT8 KV. Speculative: the bf16 parent verifies (bf16 KV),
    its PTQ drafts, k 2; the oracle is serial decode of the parent whose
    one-token steps take the prefill route (on the CPU both routes are the
    same arithmetic)."""
    cfg, parent, hqp = setup
    if "paged" in layout:
        kw.update(page_size=8, prefix_cache=False)
    if "speculative" in layout:
        params, qkv, route = parent, False, "prefill"
        kw.update(draft_params=hqp, spec_k=2)
    else:
        params, qkv, route = hqp, True, "decode"
    eng = Engine(params, cfg, n_slots=n_slots, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=chunk,
                                       decode_steps=steps),
                 quantized_kv=qkv, device="cpu", **kw)

    def oracle(prompt, n):
        return serial_decode(params, cfg, prompt, n, max_seq=MAX_SEQ,
                             quantized_kv=qkv, device="cpu", route=route)
    return eng, oracle


def _mirror_mismatches(eng):
    """Slots whose device ``pos`` differs from the host's mirror, in the
    pool or the drafter's pool."""
    bad = []
    for slot in eng.slots:
        if slot.stage == FREE:
            continue
        for name, pool in (("pool", eng.pool), ("draft", eng.draft_pool)):
            if pool is not None and \
                    int(pool["pos"][slot.idx]) != eng._host_pos(slot):
                bad.append((name, slot.idx, int(pool["pos"][slot.idx]),
                            eng._host_pos(slot)))
    return bad


def _watch_faults(eng):
    """After every absorbed fault: the mismatches left, and the slots that
    survived it with their stage."""
    seen = []
    absorb = eng._absorb_fault

    def checked():
        absorb()
        seen.append((_mirror_mismatches(eng),
                     [(s.idx, s.stage) for s in eng.slots
                      if s.stage != FREE]))
    eng._absorb_fault = checked
    return seen


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_engine_fault_isolates_the_phase(setup, layout, kind):
    """A staggered load with one injected decode (or speculative) dispatch
    fault, or one prefill chunk fault: exactly the requests of that
    dispatch (or chunk) end in ``error``, every other request, the ones
    admitted after the fault included, equals serial decode, every
    survivor's position equals its mirror in both pools, and pages return
    to the baseline with the allocator consistent."""
    cfg = setup[0]
    eng, oracle = _engine(setup, layout)
    prompts = _prompts(cfg, [13, 7, 21, 9, 16], seed=5)
    inject = (faults.inject_decode_fault if kind == "decode"
              else faults.inject_prefill_fault)
    h = inject(eng, at=3)
    inner, pick = eng.graphs.run, eng.scheduler.next_action
    actions, batches = [], []

    def next_action(*args):
        actions.append(pick(*args))
        return actions[-1]

    def record(k, key, body):       # outermost: sees the faulting call too
        if k in (faults.DECODE_KINDS if kind == "decode"
                 else faults.PREFILL_KINDS):
            act = actions[-1]
            batches.append({eng.slots[i].result.uid
                            for i in (act.slots or (act.slot,))})
        return inner(k, key, body)
    eng.scheduler.next_action = next_action
    eng.graphs.run = record
    seen = _watch_faults(eng)
    res = eng.run([Request(prompt=p, max_new_tokens=10) for p in prompts],
                  arrival_ticks=[0, 1, 3, 8, 12])
    h.restore()
    assert h.fired == 1 and len(seen) == 1 and seen[0][0] == []
    failed = {i for i, r in res.items() if r.finish_reason == "error"}
    blamed = batches[h.at - 1]
    if kind == "prefill":
        assert len(blamed) == 1
    assert {res[i].uid for i in failed} == blamed
    assert eng.stats["faults"] == len(failed) >= 1
    for i, p in enumerate(prompts):
        if i not in failed:
            assert res[i].finish_reason == "length"
            assert res[i].tokens == oracle(p, 10), i
    if eng.paged:
        assert eng.alloc.pages_in_use == 0
        eng.alloc.check()
    assert not eng.has_work and eng.n_active == 0


class Alternating(Scheduler):
    """A policy that interleaves: with slots prefilling and slots decoding,
    ticks alternate between a decode dispatch and a prefill chunk, so a
    decode dispatch runs while a slot is mid-prefill (the reference's
    policy gives prefill priority, so that never happens there)."""

    def next_action(self, prefilling, decoding):
        self._flip = not getattr(self, "_flip", False)
        if decoding and (self._flip or not prefilling):
            return Action(DECODE, slots=tuple(sorted(decoding)))
        return super().next_action(prefilling, ())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fault_mid_dispatch_restores_positions(setup, layout, monkeypatch):
    """A fault part way through a decode dispatch, raised by the model on
    the card's side of the dispatch (the verifier's pass of a speculative
    one, after its rows were parked and its drafts written; a plain one's
    second step), while another slot is mid-prefill: the dispatch's slots
    fail, the slot mid-prefill survives with its position back in both
    pools (a speculative dispatch had parked it), and it and a request
    after the fault equal serial decode."""
    cfg = setup[0]
    eng, oracle = _engine(setup, layout, n_slots=3, chunk=4, steps=3)
    eng.scheduler = Alternating(eng.scheduler.cfg)
    spec = eng.spec is not None
    name = "verify_step" if spec else "decode_step"
    orig, calls, parked = getattr(lm, name), [], []

    def flaky(*args, **kwargs):
        mid = [s for s in eng.slots if s.stage == PREFILL]
        live = spec or kwargs.get("route") == "decode"
        if live and mid and not parked:
            calls.append(1)
            if spec or len(calls) == 2:
                parked.append([(s.idx, int(eng.pool["pos"][s.idx]))
                               for s in mid])
                raise RuntimeError("injected: the model failed mid-dispatch")
        return orig(*args, **kwargs)
    monkeypatch.setattr(lm, name, flaky)
    seen = _watch_faults(eng)
    prompts = _prompts(cfg, [9, 30, 11], seed=8)
    res = eng.run([Request(prompt=p, max_new_tokens=12) for p in prompts],
                  arrival_ticks=[0, 5, 30])
    assert len(seen) == 1 and seen[0][0] == []
    # the survivor was mid-prefill, and parked by a speculative dispatch
    assert [stage for _, stage in seen[0][1]] == [PREFILL]
    idx, pos_then = parked[0][0]
    if spec:
        assert pos_then > MAX_SEQ
    assert res[0].finish_reason == "error" and eng.stats["faults"] == 1
    for i in (1, 2):
        assert res[i].tokens == oracle(prompts[i], 12), i
    if eng.paged:
        assert eng.alloc.pages_in_use == 0
        eng.alloc.check()


@pytest.mark.parametrize("exc", [AssertionError, torch.AcceleratorError,
                                 KernelError], ids=lambda e: e.__name__)
def test_fatal_faults_propagate(setup, exc):
    """An ``AssertionError``, a CUDA error and a kernel's failure are never
    absorbed: they leave ``Engine.step`` and ``Service.step`` as they are,
    with no request failed on their account."""
    cfg = setup[0]
    eng, _ = _engine(setup, "paged")
    svc = Service(eng, ServiceConfig(queue_depth=2))
    h = faults.inject_decode_fault(eng, at=1, exc=exc)
    t = svc.submit(Request(prompt=_prompts(cfg, [6])[0], max_new_tokens=4))
    with pytest.raises(exc, match="injected"):
        while svc.has_work:
            svc.step()
    h.restore()
    assert eng.stats["faults"] == 0 and svc.stats["faults"] == 0
    assert not t.done


def test_unattributable_fault_propagates_and_the_service_fails_all(setup):
    """A fault with no request to blame (here the scheduler's) leaves
    ``Engine.step``; the ``Service`` absorbs it by failing every live
    request, frees their pages, and serves on."""
    cfg = setup[0]
    eng, oracle = _engine(setup, "paged")
    svc = Service(eng, ServiceConfig(queue_depth=4))
    prompts = _prompts(cfg, [6, 8, 5], seed=2)
    a = svc.submit(Request(prompt=prompts[0], max_new_tokens=4))
    b = svc.submit(Request(prompt=prompts[1], max_new_tokens=4))
    svc.step()
    real = eng.scheduler.next_action
    eng.scheduler.next_action = lambda *a_: (_ for _ in ()).throw(
        RuntimeError("scheduler broke"))
    with pytest.raises(RuntimeError, match="scheduler broke"):
        eng.step()
    svc.step()
    eng.scheduler.next_action = real
    assert (a.finish_reason, b.finish_reason) == ("error", "error")
    assert svc.stats["faults"] == 3 and eng.stats["cancelled"] == 2
    assert eng.alloc.pages_in_use == 0
    c = svc.submit(Request(prompt=prompts[2], max_new_tokens=4))
    svc.drain()
    assert c.tokens == oracle(prompts[2], 4)


def test_first_use_and_capture_faults_serve_on(setup, monkeypatch):
    """On the card's graph policy (a fake graph that replays its body in
    place of a CUDA graph): a fault at a key's eager first use leaves the
    key unseen, a fault inside a capture keeps no graph; each fails its
    request, and the next uses run eagerly, capture and replay, equal to
    serial decode."""
    from repro_torch.serving import dispatch

    class Replay:
        def __init__(self, body):
            self.replay = body

    fail_capture = []

    def capture(self, body):
        if fail_capture:
            fail_capture.pop()
            raise RuntimeError("injected: fault inside the capture")
        return Replay(body), []
    monkeypatch.setattr(dispatch.GraphCache, "_capture", capture)
    cfg = setup[0]
    eng, oracle = _engine(setup, "paged", n_slots=1, steps=4)
    eng.graphs.device = torch.device("cuda")   # no card is touched
    prompt = _prompts(cfg, [6], seed=4)[0]
    req = Request(prompt=prompt, max_new_tokens=8)
    h = faults.inject_decode_fault(eng, at=1)
    assert eng.run([req])[0].finish_reason == "error"
    h.restore()
    assert eng.graphs.keys["prefill"] and not eng.graphs.keys["decode"]
    fail_capture.append(1)          # the prefill key's second use captures
    assert eng.run([req])[0].finish_reason == "error"
    assert not eng.graphs._graphs and eng.stats["faults"] == 2
    res = eng.run([req])[0]
    assert res.finish_reason == "length" and res.tokens == oracle(prompt, 8)
    assert {k for k, _ in eng.graphs._graphs} == {"prefill", "decode"}
    assert eng.stats["graph_replays"] >= 2


# ------------------------------------------------------------ cancel, spans
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cancel_queued_mid_prefill_mid_decode(setup, layout):
    cfg = setup[0]
    eng, oracle = _engine(setup, layout, n_slots=2, chunk=5)
    prompts = _prompts(cfg, [20, 6, 7, 8], seed=9)
    a, b, c = (eng.submit(Request(prompt=p, max_new_tokens=6))
               for p in prompts[:3])
    eng.step()                              # A and B admitted, C queued
    assert eng.n_active == 2 and len(eng.waiting) == 1
    assert eng.cancel(c)                    # queued
    assert eng.slots[0].stage == PREFILL and eng.slots[0].prefill_done < 20
    assert eng.cancel(a)                    # mid-prefill
    while not eng.slots[1].result or not eng.slots[1].result.tokens:
        eng.step()
    assert eng.slots[1].stage == DECODE
    assert eng.cancel(b)                    # mid-decode
    assert not eng.cancel(b) and not eng.cancel(999)
    assert eng.stats["cancelled"] == 3 and not eng.has_work
    for slot in eng.slots:
        assert (slot.stage, slot.pages, slot.n_shared, slot.prev_token) \
            == (FREE, [], 0, 0)
    if eng.paged:
        assert eng.alloc.pages_in_use == 0
        eng.alloc.check()
    # both slots serve again, in both pools
    res = eng.run([Request(prompt=p, max_new_tokens=6)
                   for p in prompts[2:]])
    for i, p in enumerate(prompts[2:]):
        assert res[i].tokens == oracle(p, 6)


def test_last_step_phases_and_token_deltas(setup):
    cfg = setup[0]
    eng, _ = _engine(setup, "paged", n_slots=2, chunk=8, steps=4)
    now, clk = _ticking_clock()
    svc = Service(eng, ServiceConfig(queue_depth=4), clock=clk)
    assert eng.clock is clk
    t = svc.submit(Request(prompt=_prompts(cfg, [10], seed=2)[0],
                           max_new_tokens=5))
    seen = []
    while svc.has_work:
        svc.step()
        seen.append(eng.last_step)
    assert t.finish_reason == "length"
    # chunks of 8 and 2 (the tail emits the first token), then a decode
    # dispatch of 4 steps
    assert [s["prefill_tokens"] for s in seen] == [8, 2, 0]
    assert [s["decode_tokens"] for s in seen] == [0, 0, 4]
    assert set(seen[1]["phases"]) == {"admit", "prefill_dispatch",
                                      "host_sync", "token_fanout", "total"}
    assert set(seen[2]["phases"]) == {"admit", "decode_scan", "host_sync",
                                      "token_fanout", "total"}
    for s in seen:
        assert set(s["phases"]) <= set(schema.PHASES)
        assert s["wall_s"] == s["phases"]["total"] > 0
        parts = sum(v for k, v in s["phases"].items() if k != "total")
        assert parts <= s["wall_s"] + 1e-12
    th = svc._phase_hists["total"]
    assert th.count == len(seen)
    assert svc._latency_hist.sum == pytest.approx(t.latency_s)
    assert svc._ttft_hist.sum == pytest.approx(t.ttft_s)
    s = telemetry.parse_exposition(svc.render_metrics())["samples"]
    assert s[(schema.PHASE_HISTOGRAM + "_count",
              (("phase", "decode_scan"),))] == 1


def _lifecycle_ok(rec, uids):
    """Exactly one terminal per uid; queued+active tile request exactly
    (same injected timestamps on both sides)."""
    assert rec.open_uids() == []
    assert sorted(rec.terminals) == sorted(uids)
    by_uid = {}
    for r in rec.records:
        if r.get("uid") is not None:
            by_uid.setdefault(r["uid"], []).append(r)
    for uid in uids:
        recs = by_uid[uid]
        fins = [r for r in recs
                if r["type"] == "instant" and r["name"] == "finish"]
        assert len(fins) == 1 and "duplicate" not in fins[0]["args"], uid
        assert fins[0]["args"]["reason"] in schema.TERMINAL_REASONS
        req = [r for r in recs
               if r["type"] == "span" and r["name"] == "request"]
        parts = sorted((r for r in recs if r["type"] == "span"
                        and r["name"] in ("queued", "active")),
                       key=lambda r: r["t0"])
        assert len(req) == 1
        assert sum(r["t1"] - r["t0"] for r in parts) == pytest.approx(
            req[0]["t1"] - req[0]["t0"])
        for x, y in zip(parts, parts[1:]):
            assert y["t0"] >= x["t1"]
        assert {r["name"] for r in recs} <= set(schema.SPAN_NAMES) | set(
            schema.INSTANT_NAMES)


@pytest.mark.parametrize("layout", ["paged", "speculative"])
def test_spans_one_terminal_under_faults_and_cancel(setup, layout):
    cfg = setup[0]
    eng, _ = _engine(setup, layout, n_slots=2, chunk=8)
    rec = eng.tracer = telemetry.SpanRecorder()
    now, clk = _ticking_clock()
    svc = Service(eng, ServiceConfig(queue_depth=4), clock=clk)
    h = faults.inject_decode_fault(eng, at=1)
    a = svc.submit(Request(prompt=_prompts(cfg, [7], seed=3)[0],
                           max_new_tokens=4))
    b = svc.submit(Request(prompt=_prompts(cfg, [9], seed=3)[0],
                           max_new_tokens=4))
    while svc.has_work:
        svc.step()
    h.restore()
    assert (a.finish_reason, b.finish_reason) == ("error", "error")
    c = svc.submit(Request(prompt=_prompts(cfg, [8], seed=4)[0],
                           max_new_tokens=6))
    svc.step()
    assert svc.cancel(c.uid)
    d = svc.submit(Request(prompt=_prompts(cfg, [6], seed=4)[0],
                           max_new_tokens=3))
    svc.drain()
    _lifecycle_ok(rec, [a.uid, b.uid, c.uid, d.uid])
    assert [rec.terminals[t.uid] for t in (a, b, c, d)] == [
        "error", "error", "cancelled", "length"]
    steps = [r for r in rec.records if r["name"] == "step"]
    assert steps and all(r["uid"] is None for r in steps)


# ------------------------------------------------------------------ Service
def test_shed_exactly_at_saturation(setup):
    cfg = setup[0]
    eng, _ = _engine(setup, "contiguous", n_slots=1, chunk=8)
    svc = Service(eng, ServiceConfig(queue_depth=1))
    assert svc.capacity == 2
    reqs = [Request(prompt=p, max_new_tokens=2)
            for p in _prompts(cfg, [6, 6, 6, 6])]
    a, b = svc.submit(reqs[0]), svc.submit(reqs[1])
    assert a is not None and b is not None
    assert svc.submit(reqs[2]) is None
    assert svc.last_shed["reason"] == "saturated"
    assert svc.stats["shed"] == 1 and svc.stats["submitted"] == 2
    while not a.done:
        svc.step()
    c = svc.submit(reqs[3])
    assert c is not None and svc.stats["shed"] == 1
    svc.drain()
    assert b.done and c.done and svc.stats["completed"] == 3
    assert not svc.tickets


@pytest.mark.parametrize("layout", ["paged", "speculative paged"])
def test_deadline_evicts_queued_and_mid_prefill_frees_pages(setup, layout):
    cfg = setup[0]
    eng, oracle = _engine(setup, layout, n_slots=1, chunk=4)
    now, clock = _fake_clock()
    svc = Service(eng, ServiceConfig(queue_depth=2), clock=clock)
    p_long, p_short = _prompts(cfg, [16, 8], seed=3)
    a = svc.submit(Request(prompt=p_long, max_new_tokens=4), deadline_s=5.0)
    b = svc.submit(Request(prompt=p_short, max_new_tokens=4),
                   deadline_s=5.0)
    svc.step()                   # A admitted, one 4-token chunk of 16
    assert eng.n_active == 1 and len(eng.waiting) == 1
    assert not a.tokens and eng.alloc.pages_in_use > 0
    now[0] = 100.0
    svc.step()
    assert (a.finish_reason, b.finish_reason) == ("deadline", "deadline")
    assert not eng.has_work and eng.alloc.pages_in_use == 0
    eng.alloc.check()
    assert svc.stats["expired"] == 2 and eng.stats["cancelled"] == 2
    c = svc.submit(Request(prompt=p_short, max_new_tokens=2))
    svc.drain()
    assert c.tokens == oracle(p_short, 2) and eng.alloc.pages_in_use == 0


def test_drain_completes_all_admitted_and_sheds_new(setup):
    cfg = setup[0]
    eng, _ = _engine(setup, "contiguous", n_slots=2, chunk=8)
    svc = Service(eng, ServiceConfig(queue_depth=4))
    tickets = [svc.submit(Request(prompt=p, max_new_tokens=3))
               for p in _prompts(cfg, [6, 7, 8, 9], seed=5)]
    svc.drain()
    assert all(t.finish_reason == "length" and len(t.tokens) == 3
               for t in tickets)
    assert svc.stats["completed"] == 4 and not svc.has_work
    assert svc.submit(Request(prompt=[1, 2, 3], max_new_tokens=2)) is None
    assert svc.last_shed["reason"] == "draining"


# ------------------------------------------------------------ HTTP loopback
async def _http(port, method, path, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return raw


def _parse_sse(raw: bytes):
    head, _, payload = raw.partition(b"\r\n\r\n")
    events = []
    for block in payload.decode().strip().split("\n\n"):
        lines = dict(line.split(": ", 1) for line in block.splitlines())
        events.append((lines["event"], json.loads(lines["data"])))
    return head.decode(), events


def test_http_sse_loopback_metrics_and_errors(setup):
    """SSE framing (tokens then exactly one ``done``) with the tokens of
    ``Engine.run``; a faulted stream ends in ``event: error``; /healthz,
    /stats and /metrics (every declared family) answer; a bad body is
    400; every dispatch ran on the pump thread."""
    cfg = setup[0]
    eng, oracle = _engine(setup, "paged", n_slots=2, chunk=8)
    prompt = _prompts(cfg, [7], seed=9)[0]
    svc = Service(eng, ServiceConfig(queue_depth=4))
    door = HttpFrontDoor(svc, host="127.0.0.1", port=0)
    threads = set()
    inner = eng.graphs.run

    def record(kind, key, body):
        threads.add(threading.get_ident())
        return inner(kind, key, body)
    eng.graphs.run = record

    async def scenario():
        await door.start()
        body = json.dumps({"prompt": prompt, "max_new_tokens": 4}).encode()
        head, events = _parse_sse(await asyncio.wait_for(
            _http(door.port, "POST", "/v1/generate", body), timeout=60))
        assert head.startswith("HTTP/1.1 200") and "text/event-stream" in head
        assert [n for n, _ in events] == ["token"] * 4 + ["done"]
        assert [d["token"] for n, d in events if n == "token"] == \
            oracle(prompt, 4)
        assert events[-1][1]["finish_reason"] == "length"
        h = faults.inject_decode_fault(eng, at=1)
        head, events = _parse_sse(await asyncio.wait_for(
            _http(door.port, "POST", "/v1/generate", body), timeout=60))
        h.restore()
        assert head.startswith("HTTP/1.1 200")
        assert events[-1][0] == "error"
        assert events[-1][1]["finish_reason"] == "error"
        for path in ("/healthz", "/stats"):
            raw = await _http(door.port, "GET", path)
            health = json.loads(raw.partition(b"\r\n\r\n")[2])
            assert health["status"] == "ok"
            assert health["service"]["completed"] == 1
            assert health["engine"]["faults"] == 1
            assert health["engine"]["pages_in_use"] == 0
        raw = await _http(door.port, "GET", "/metrics")
        head, _, payload = raw.partition(b"\r\n\r\n")
        assert b"version=0.0.4" in head
        raw = await _http(door.port, "POST", "/v1/generate", b"{not json")
        assert raw.startswith(b"HTTP/1.1 400")
        await asyncio.wait_for(door.stop(drain=True), timeout=60)
        return payload.decode()

    parsed = telemetry.parse_exposition(asyncio.run(scenario()))
    assert set(schema.metric_names()) <= set(parsed["types"])
    s = parsed["samples"]
    assert s[(schema.SERVICE_PREFIX + "completed", ())] == 1
    assert s[(schema.SERVICE_PREFIX + "faults", ())] == 1
    assert threads == {door._pump_thread.ident}
    assert not door._pump_thread.is_alive() and door.pump_error is None


def test_http_hardening_and_client_chaos(setup):
    """Socket-edge faults each get their own clean answer without touching
    the pump (non-POST generate and bad prompts 400, an oversized body 413,
    a slow-loris 408), and a client that vanishes mid-stream frees its
    slot and pages (the stdlib-socket helpers of ``serving.faults``)."""
    cfg = setup[0]
    eng, _ = _engine(setup, "paged", n_slots=1, chunk=8)
    svc = Service(eng, ServiceConfig(queue_depth=2))
    door = HttpFrontDoor(svc, host="127.0.0.1", port=0, max_body_bytes=256,
                         request_timeout_s=0.3)

    async def scenario():
        await door.start()
        port = door.port
        raw = await _http(port, "GET", "/v1/generate")
        assert raw.startswith(b"HTTP/1.1 400") and b"use POST" in raw
        for bad in ({"prompt": "not a list"}, {"prompt": [1, "x"]},
                    {"prompt": []}, {"prompt": [1, 2], "max_new_tokens": 0},
                    {"prompt": [1] * 60, "max_new_tokens": 60}):
            raw = await _http(port, "POST", "/v1/generate",
                              json.dumps(bad).encode())
            assert raw.startswith(b"HTTP/1.1 400"), bad
        big = (b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
               b"Content-Length: 999999\r\n\r\n")
        line = await asyncio.to_thread(faults.http_malformed, "127.0.0.1",
                                       port, big)
        assert line.startswith("HTTP/1.1 413")
        line = await asyncio.to_thread(faults.http_slow_loris, "127.0.0.1",
                                       port, 0.3)
        assert line.startswith("HTTP/1.1 408")
        assert svc.stats["submitted"] == 0
        seen = await asyncio.to_thread(
            faults.http_disconnect_mid_stream, "127.0.0.1", port,
            {"prompt_len": 8, "max_new_tokens": 40}, 1)
        assert seen >= 1
        for _ in range(500):
            if svc.stats["cancelled"]:
                break
            await asyncio.sleep(0.01)
        await asyncio.wait_for(door.stop(drain=True), timeout=60)

    asyncio.run(scenario())
    assert svc.stats["cancelled"] == 1 and eng.stats["cancelled"] == 1
    assert eng.alloc.pages_in_use == 0 and not eng.has_work
    eng.alloc.check()


def test_watchdog_and_pump_failure_escalate(setup):
    """The watchdog judges only the pump heartbeat: a stale one fires
    ``on_wedged`` once (the default escalation exits), a fresh one never.
    A pump whose engine raises a fault that must not be absorbed stops,
    keeps the fault and escalates the same way."""
    cfg = setup[0]
    eng, _ = _engine(setup, "contiguous", n_slots=1, chunk=8)
    svc = Service(eng, ServiceConfig(queue_depth=1))
    rec = []
    door = HttpFrontDoor(svc, host="127.0.0.1", port=0, watchdog_s=0.05,
                         on_wedged=rec.append)
    door._beat = time.monotonic() - 10.0
    t = threading.Thread(target=door._watch)
    t.start()
    t.join(timeout=5)
    assert not t.is_alive() and len(rec) == 1 and "WATCHDOG" in rec[0]
    rec.clear()
    door.watchdog_s = 5.0
    door._beat = time.monotonic()
    t = threading.Thread(target=door._watch)
    t.start()
    time.sleep(0.05)
    door._stop_pump.set()
    t.join(timeout=10)
    assert not t.is_alive() and not rec
    assert HttpFrontDoor(svc, watchdog_s=60.0).on_wedged.__name__ == \
        "_exit_wedged"

    door = HttpFrontDoor(svc, host="127.0.0.1", port=0, on_wedged=rec.append)
    svc.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))
    eng.step = lambda: (_ for _ in ()).throw(AssertionError("invariant"))
    t = threading.Thread(target=door._pump)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert isinstance(door.pump_error, AssertionError)
    assert len(rec) == 1 and "PUMP FAILED" in rec[0]


# ---------------------------------------------------------- allocator storms
_STORM = {}


def _storm_engine():
    if not _STORM:
        cfg = configs.get_smoke_config(ARCH)
        params = quantize_lm_params(lm.init_params(cfg, seed=0,
                                                   device="cpu"))
        _STORM["cfg"] = cfg
        _STORM["eng"] = Engine(params, cfg, n_slots=2, max_seq=MAX_SEQ,
                               sched=SchedulerConfig(prefill_chunk=8),
                               quantized_kv=True, device="cpu", page_size=8,
                               prefix_cache=False)
    return _STORM["cfg"], _STORM["eng"]


@settings(deadline=None, max_examples=10)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 6)),
                max_size=14))
def test_storm_returns_the_allocator_to_baseline(ops):
    """Random interleavings of admit, deadline-admit, clock jumps (expiry),
    cancels and injected decode faults, stepping between ops: draining
    always returns the allocator to zero pages with its refcounts intact,
    every ticket ends, every uid has exactly one terminal span, and the
    service's counts add up."""
    cfg, eng = _storm_engine()
    rec = eng.tracer = telemetry.SpanRecorder()
    fault = None
    try:
        now = [0.0]
        svc = Service(eng, ServiceConfig(queue_depth=3),
                      clock=lambda: now[0])
        rng = np.random.RandomState(17)
        tickets = []
        for op, n in ops:
            if op in (0, 1):
                t = svc.submit(
                    Request(prompt=rng.randint(0, cfg.vocab_size,
                                               5 + n).tolist(),
                            max_new_tokens=1 + n % 4),
                    deadline_s=0.5 * (n + 1) if op == 1 else None)
                if t is not None:
                    tickets.append(t)
            elif op == 2:
                now[0] += 0.6 * (n + 1)
            elif op == 3 and svc.tickets:
                svc.cancel(sorted(svc.tickets)[n % len(svc.tickets)])
            elif op == 4 and fault is None:
                fault = faults.inject_decode_fault(eng, at=1 + n % 2)
            svc.step()
        svc.drain()
        assert not svc.tickets and all(t.done for t in tickets)
        assert eng.alloc.pages_in_use == 0
        eng.alloc.check()
        s = svc.stats
        assert s["submitted"] == (s["completed"] + s["expired"]
                                  + s["cancelled"] + s["faults"])
        _lifecycle_ok(rec, [t.uid for t in tickets])
    finally:
        if fault is not None:
            fault.restore()
        eng.tracer = None


# ----------------------------------------------------------------- launcher
def test_serve_replays_a_trace_with_spans_and_profile(tmp_path, capsys):
    """``serve --engine --trace`` replays a JSONL trace (prompts given and
    synthesized), verifies it against serial decode, and writes the spans
    (``--trace-dir``) and a torch.profiler trace (``--profile-dir``)."""
    trace = tmp_path / "trace.jsonl"
    trace.write_text("\n".join(json.dumps(d) for d in (
        {"arrival_s": 0.0, "prompt": [5, 9, 2, 7, 1], "max_new_tokens": 4},
        {"arrival_s": 0.01, "prompt_len": 9, "max_new_tokens": 3},
        {"arrival_s": 0.02, "prompt_len": 6})) + "\n")
    stats = serve.main([
        "--smoke", "--device", "cpu", "--engine", "--verify", "--max-seq",
        "48", "--trace", str(trace), "--trace-dir", str(tmp_path / "spans"),
        "--profile-dir", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert stats["n_requests"] == 3 and stats["latency_hist"]["count"] == 3
    assert "all 3 outputs token-identical" in out
    chrome = json.loads((tmp_path / "spans" / "trace.json").read_text())
    assert {e["name"] for e in chrome["traceEvents"]} >= {"request",
                                                          "prefill"}
    assert (tmp_path / "spans" / "spans.jsonl").stat().st_size > 0
    assert json.loads((tmp_path / "prof" / "profile.json").read_text())
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--http", "--trace",
                    str(trace)])


def test_serve_http_cli_streams_and_drains(tmp_path):
    """``python -m repro_torch.launch.serve --engine --http --port 0`` on
    the CPU: it warms up, listens, streams one request over SSE, and on
    SIGTERM drains and exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--engine", "--http", "--port", "0",
         "--page-size", "16", "--no-prefix-cache", "--watchdog-s", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "listening on" in line:
                break
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        head, events = _parse_sse(asyncio.run(asyncio.wait_for(_http(
            port, "POST", "/v1/generate",
            json.dumps({"prompt_len": 8, "max_new_tokens": 4}).encode()),
            timeout=60)))
        assert [n for n, _ in events] == ["token"] * 4 + ["done"]
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, "".join(lines) + rest
    assert any("warm-up" in x for x in lines)
    assert "drained cleanly: served 1 requests" in rest
