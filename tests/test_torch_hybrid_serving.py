"""The continuous-batching engine serving the hybrid family (jamba) on the
CPU (the plain versions of the kernels): the launcher's HQP artifact of the
smoke model (Fisher, Algorithm 1 with the ``mamba_cols`` family,
compaction, INT8 PTQ) equals serial decode bit for bit, contiguous and
paged, greedy and sampled, with staggered arrivals. The recurrent state
lives in the pool beside the KV: it is zeroed at admission, left bit for
bit untouched for rows that are not live in a dispatch (free, mid-prefill,
or stopped mid-dispatch at EOS), written only at a dispatch's end, and a
faulted dispatch leaves the survivors' state where their positions say.
Fault C8: the reference engine's prefix cache admits a slot past a shared
head whose recurrent state it does not hold, and its output leaves serial
decode; the port keeps no prefix cache for a recurrent pattern. And
speculative decoding, which refuses the family (it rolls caches back by
position), and a train step, which takes it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402,E501
from repro_torch import configs  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.serving import Engine, Request, SchedulerConfig  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.serving import state_pool as sp  # noqa: E402
from repro_torch.serving.faults import inject_decode_fault  # noqa: E402
from repro_torch.serving.sampling import SamplingConfig  # noqa: E402
from repro_torch.serving.scheduler import DECODE, Action, Scheduler  # noqa: E402,E501
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402,E501
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "jamba-1.5-large-398b"
MAX_SEQ = 64
SAMPLED = SamplingConfig(temperature=0.8, top_k=50, seed=7)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The smoke config, its seed-0 bf16 params, and the launcher's HQP
    artifact of them (three conditional steps)."""
    cfg = configs.get_smoke_config(ARCH)
    parent = lm.init_params(cfg, seed=0, device="cpu")
    art = serve.build_artifact(parent, cfg, prune_steps=3,
                               log=lambda s: None)
    return cfg, parent, art


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


class Interleave(Scheduler):
    """Alternates decode dispatches with prefill chunks while both are due,
    so decode dispatches run with a slot mid-prefill (the engine's policy
    gives prefill priority, and a prompt's chunks would run back to
    back)."""
    flip = False

    def next_action(self, prefilling, decoding):
        self.flip = not self.flip
        if decoding and (self.flip or not prefilling):
            return Action(DECODE, slots=tuple(sorted(decoding)))
        return super().next_action(prefilling, ())


def _engine(params, cfg, page_size=None, n_slots=3, chunk=5,
            interleave=False, **kw):
    eng = Engine(params, cfg, n_slots=n_slots, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=chunk, decode_steps=4),
                 quantized_kv=True, device="cpu", page_size=page_size, **kw)
    if interleave:
        eng.scheduler = Interleave(eng.scheduler.cfg)
    return eng


def _serial(params, cfg, prompt, n, **kw):
    return serial_decode(params, cfg, prompt, n, max_seq=MAX_SEQ,
                         quantized_kv=True, device="cpu", **kw)


def _mamba(pool):
    return [e for e in pool["caches"] if not sp.is_kv_entry(e)]


def test_artifact_cuts_and_quantizes_the_mamba_layer(setup):
    """The launcher's artifact: the Mamba layer's in_proj and out_proj
    INT8, x_proj and dt_proj FP; the engine's pool sized from the
    artifact's own ``conv_w`` (its channels were cut)."""
    cfg, _, art = setup
    m = art.manifest
    assert m.pruned and len(m.history) == 3
    assert set(m.theta_by_family) == {"L0/ffn", "L0/mamba_cols",
                                      "L1/kv_heads", "L1/experts"}
    mb = art.params["blocks"][0]["mamba"]
    assert isinstance(mb["in_proj"], QuantizedLinear)
    assert isinstance(mb["out_proj"], QuantizedLinear)
    assert mb["x_proj"]["w"].dtype == torch.bfloat16
    assert mb["dt_proj"]["w"].dtype == torch.float32
    d_in = mb["conv_w"].shape[-1]
    assert d_in == cfg.ssm.expand * cfg.d_model * (
        1 - m.theta_by_family["L0/mamba_cols"])
    for page_size in (None, 16):
        eng = _engine(art.params, cfg, page_size)
        (entry,) = _mamba(eng.pool)
        assert entry["h"].shape == (3, d_in, cfg.ssm.d_state)
        assert entry["conv"].shape == (3, cfg.ssm.d_conv - 1, d_in)


@pytest.mark.parametrize("interleave", [False, True],
                         ids=["prefill-first", "interleaved"])
@pytest.mark.parametrize("sampling", [None, SAMPLED],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_engine_equals_serial_decode(setup, page_size, sampling, interleave):
    """Staggered arrivals into 3 slots (a slot is reused, so admission
    must zero its recurrent state), a prefill chunk (5) that divides no
    prompt, 4 decode steps a host sync, INT8 KV, under the engine's
    prefill-first policy and with decode dispatches interleaved with a
    slot mid-prefill: every request token-identical to serial decode of
    the artifact."""
    cfg, _, art = setup
    prompts = _prompts(cfg, [13, 7, 30, 21], seed=2)
    eng = _engine(art.params, cfg, page_size, sampling=sampling,
                  interleave=interleave)
    res = eng.run([Request(prompt=p, max_new_tokens=10) for p in prompts],
                  arrival_ticks=[0, 2, 6, 9])
    assert eng.stats["decode_ticks"] > 0 and eng.stats["prefill_ticks"] > 4
    for i, p in enumerate(prompts):
        assert res[i].tokens == _serial(art.params, cfg, p, 10,
                                        sampling=sampling), i
    if eng.paged:
        assert eng.prefix is None and eng.stats["prefix_hits"] == 0
        eng.alloc.check()
        assert eng.alloc.pages_in_use == 0


def _snapshot(pool):
    return [{k: v.clone() for k, v in e.items()} for e in _mamba(pool)]


@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_rows_not_live_keep_their_state(setup, page_size):
    """Request 0 stops at EOS on the first step of its first decode
    dispatch, which runs three more steps: its recurrent state after the
    dispatch is the state serial decode has after the tokens it consumed,
    bit for bit. Request 1, whose long prompt is mid-prefill during the
    decode dispatches, and the free slot keep their state bit for bit
    across every decode dispatch; request 1 then still equals serial
    decode."""
    cfg, _, art = setup
    p0, p1 = _prompts(cfg, [6, 30], seed=3)
    first = _serial(art.params, cfg, p0, 2)
    eng = _engine(art.params, cfg, page_size, chunk=4, interleave=True)
    dispatches = []
    run = eng.graphs.run

    def watched(kind, key, body):
        if kind != "decode":
            return run(kind, key, body)
        idle = [s.idx for s in eng.slots if s.stage != "decode"]
        live = [s.idx for s in eng.slots if s.stage == "decode"]
        before = _snapshot(eng.pool)
        out = run(kind, key, body)
        dispatches.append((idle, live, before, _snapshot(eng.pool)))
        return out

    eng.graphs.run = watched
    res = eng.run([Request(prompt=p0, max_new_tokens=8, eos_id=first[1]),
                   Request(prompt=p1, max_new_tokens=6)],
                  arrival_ticks=[0, 2])
    assert res[0].tokens == first and res[0].finish_reason == "eos"
    assert res[1].tokens == _serial(art.params, cfg, p1, 6)
    # request 0 sat in slot 0; its first decode dispatch stopped it
    idle, live, _, after = dispatches[0]
    assert live == [0] and 1 in idle and 2 in idle
    st = lm.init_decode_state(cfg, 1, MAX_SEQ, params=art.params,
                              quantized_kv=True, device="cpu")
    _, st = lm.decode_step(art.params, cfg, st, torch.tensor([p0]),
                           route="prefill")
    _, st = lm.decode_step(art.params, cfg, st, torch.tensor([[first[0]]]),
                           route="decode")
    want = [e for e in st["caches"] if not sp.is_kv_entry(e)]
    for a, w in zip(after, want):
        for k in ("h", "conv"):
            assert torch.equal(a[k][0], w[k][0]), k
    mid_prefill = 0
    for idle, _, before, after in dispatches:
        for b, a in zip(before, after):
            for k in ("h", "conv"):
                for i in idle:
                    assert torch.equal(a[k][i], b[k][i]), (k, i)
        mid_prefill += 1 in idle
    assert mid_prefill >= 1


def _survivors(eng, res, prompts, n, art, cfg):
    ok = [i for i, r in res.items() if r.finish_reason != "error"]
    for i in ok:
        assert res[i].tokens == _serial(art.params, cfg, prompts[i], n), i
    return ok


@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_decode_fault_survivors_equal_serial(setup, page_size):
    """The second decode dispatch raises (``faults.inject_decode_fault``):
    its requests end ``error``, and every other request, a slot
    mid-prefill at the fault among them, still equals serial decode. The
    fault path resets a survivor's position alone: zeroing its recurrent
    state there would wipe the prefix it had prefilled."""
    cfg, _, art = setup
    prompts = _prompts(cfg, [6, 8, 30, 11], seed=4)
    eng = _engine(art.params, cfg, page_size, chunk=4, interleave=True)
    handle = inject_decode_fault(eng, at=2)
    stages = []
    absorb = eng._absorb_fault

    def noted():
        stages.append([(s.idx, s.stage, s.prefill_done, s.result.uid)
                       for s in eng.slots if s.stage != "free"])
        absorb()

    eng._absorb_fault = noted
    res = eng.run([Request(prompt=p, max_new_tokens=7) for p in prompts],
                  arrival_ticks=[0, 0, 1, 12])
    handle.restore()
    assert handle.fired == 1 and len(stages) == 1
    failed = [i for i, r in res.items() if r.finish_reason == "error"]
    assert failed and len(failed) < len(prompts)
    ok = _survivors(eng, res, prompts, 7, art, cfg)
    assert any(stage == "prefill" and done > 0
               for _, stage, done, _ in stages[0]), stages
    assert len(ok) >= 2


@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_fault_part_way_through_a_dispatch(setup, page_size, monkeypatch):
    """A fault raised from inside the model on the second step of a
    decode dispatch, after the first step moved the live rows' positions
    in place: the dispatch's requests fail, and the survivors (one
    mid-prefill, one not yet admitted) still equal serial decode: the
    pool's recurrent state is written only at a dispatch's end."""
    cfg, _, art = setup
    prompts = _prompts(cfg, [6, 30, 9], seed=5)
    eng = _engine(art.params, cfg, page_size, chunk=4, interleave=True)
    calls = {"decode": 0, "mamba": 0}
    run = eng.graphs.run
    forward = ssm.mamba_forward

    def counted(kind, key, body):
        if kind == "decode":
            calls["decode"] += 1
            calls["mamba"] = 0
        return run(kind, key, body)

    def flaky(p, c, x, state=None, batch_invariant=True):
        if state is not None and x.shape[1] == 1 and calls["decode"] == 2:
            calls["mamba"] += 1
            if calls["mamba"] == 2:
                raise RuntimeError("injected part way through a dispatch")
        return forward(p, c, x, state, batch_invariant)

    eng.graphs.run = counted
    monkeypatch.setattr(ssm, "mamba_forward", flaky)
    res = eng.run([Request(prompt=p, max_new_tokens=9) for p in prompts],
                  arrival_ticks=[0, 2, 14])
    monkeypatch.setattr(ssm, "mamba_forward", forward)
    assert eng.stats["faults"] >= 1
    assert res[0].finish_reason == "error"
    ok = _survivors(eng, res, prompts, 9, art, cfg)
    assert 1 in ok and 2 in ok


def test_state_pool_recurrent_half(setup):
    """The pool's recurrent entries keep their slot axis in the paged
    layout; admission zeroes one slot's; the fault path's position reset
    leaves them; a paged slot's state gathers and scatters through its
    index tensor; copy-on-write and the KV byte counts touch KV entries
    only."""
    cfg, _, art = setup
    pool = sp.init_paged_pool(cfg, 3, MAX_SEQ, page_size=8, total_pages=9,
                              params=art.params, quantized_kv=True,
                              device="cpu")
    (rec,) = _mamba(pool)
    (kv,) = sp.kv_entries(pool)
    assert rec["h"].shape[0] == 3 and kv["k_q"].shape[:2] == (9, 8)
    for leaf in rec.values():
        leaf.normal_()
    keep = {k: v.clone() for k, v in rec.items()}
    sp.reset_slot(pool, 1, pos0=5)
    assert int(pool["pos"][1]) == 5
    for k, v in rec.items():
        assert not v[1].any()
        assert torch.equal(v[0], keep[k][0]) and torch.equal(v[2],
                                                             keep[k][2])
    sp.set_slot_pos(pool, 2, 7)
    assert int(pool["pos"][2]) == 7 and torch.equal(rec["h"][2],
                                                    keep["h"][2])
    idx = torch.tensor([2])
    st = sp.gather_slot(pool, idx, pages=torch.zeros((1, 8),
                                                     dtype=torch.int32))
    assert st["caches"][1] is kv and torch.equal(st["caches"][0]["h"],
                                                  rec["h"][2:3])
    new = {"caches": [{k: torch.full_like(v, 3.0)
                       for k, v in st["caches"][0].items()}, kv],
           "pos": torch.tensor([11], dtype=torch.int32)}
    sp.scatter_slot(pool, idx, new)
    assert (rec["h"][2] == 3).all() and int(pool["pos"][2]) == 11
    assert torch.equal(rec["h"][0], keep["h"][0])
    kv["k_q"][2].fill_(5)
    before = {k: v.clone() for k, v in rec.items()}
    sp.copy_page(pool, 2, 4)
    assert (kv["k_q"][4] == 5).all()
    assert all(torch.equal(rec[k], before[k]) for k in rec)
    eng = _engine(art.params, cfg, 16)
    assert eng.stats["kv_bytes"] == sum(
        t.numel() * t.element_size() for e in sp.kv_entries(eng.pool)
        for t in e.values())


def test_c8_reference_diverges_port_does_not():
    """Fault C8. The reference engine, paged with its default prefix cache,
    admits request 1 at its 16-token head (a prefix hit) and resumes
    prefill there, but its Mamba layer was zeroed at admission and never
    sees the head: request 1 leaves serial decode. The port, on the same
    weights and input, keeps no prefix cache for a recurrent pattern:
    paged == contiguous == serial decode, 0 prefix hits."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab_size, 16).tolist()
    prompts = [head + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 7)]
    jeng = jengine.Engine(jp, jcfg, n_slots=2, max_seq=64,
                          sched=JSchedulerConfig(prefill_chunk=8),
                          page_size=8)
    jres = jeng.run([jengine.Request(prompt=p, max_new_tokens=6)
                     for p in prompts], arrival_ticks=[0, 12])
    jserial = [jengine.serial_decode(jp, jcfg, p, 6, max_seq=64)
               for p in prompts]
    assert jeng.stats["prefix_hits"] == 1
    assert jres[0].tokens == jserial[0]
    assert jres[1].tokens != jserial[1]

    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    want = [serial_decode(tp, cfg, p, 6, max_seq=64, device="cpu")
            for p in prompts]
    for page_size in (8, None):
        eng = Engine(tp, cfg, n_slots=2, max_seq=64,
                     sched=SchedulerConfig(prefill_chunk=8), device="cpu",
                     page_size=page_size, prefix_cache=True)
        res = eng.run([Request(prompt=p, max_new_tokens=6) for p in prompts],
                      arrival_ticks=[0, 12])
        assert eng.prefix is None and eng.stats["prefix_hits"] == 0
        assert [res[i].tokens for i in range(2)] == want, page_size


def test_speculative_decoding_refuses_the_hybrid(setup):
    """Speculative decoding rolls caches back by position, which recurrent
    state cannot do: the engine refuses a hybrid verifier/drafter pair,
    as the reference does."""
    cfg, parent, art = setup
    with pytest.raises(NotImplementedError, match="recurrent"):
        Engine(parent, cfg, n_slots=2, max_seq=MAX_SEQ, device="cpu",
               draft_params=art.params, spec_k=4)


@pytest.mark.parametrize("moe", [True, False], ids=["jamba", "dense-hybrid"])
def test_training_refuses_the_hybrid(moe):
    """Training the hybrid family is ported (the name is this test's from
    when ``make_train_step`` refused it): a step of jamba's smoke config,
    and of its pattern with the MoE layers made dense, at the launcher's
    drops, is finite and moves the weights; jamba reports the auxiliary
    losses of its MoE layer, the dense pattern none."""
    cfg = configs.get_smoke_config(ARCH)
    if not moe:
        cfg = dataclasses.replace(cfg, moe=None)
    ocfg = AdamWConfig(lr=1e-3)
    params = lm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 17)))
    new, _, m = make_train_step(cfg, ocfg, moe_no_drop=False)(
        params, adamw_init(params, ocfg), {"tokens": tokens})
    assert sorted(m) == (["aux/load_balance", "aux/router_z", "loss"]
                         if moe else ["loss"])
    assert all(np.isfinite(float(v)) for v in m.values())
    a = new["blocks"][0]["mamba"]["in_proj"]["w"]
    assert torch.isfinite(a.float()).all()
    assert not torch.equal(a, params["blocks"][0]["mamba"]["in_proj"]["w"])


@pytest.mark.parametrize("page_size", [None, "16"], ids=["contiguous",
                                                         "paged"])
def test_serve_cli_verifies_the_hybrid_arch(capsys, page_size):
    """``serve --arch jamba-1.5-large-398b --smoke --engine --hqp``: the
    manifest's Mamba family, engine == serial decode, and paged, the
    summary says that the recurrent pattern runs without a prefix
    cache."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
            "--hqp", "--prune-steps", "3", "--tokens", "6", "--prompt-len",
            "9", "--max-seq", "32", "--verify"]
    serve.main(argv + (["--page-size", page_size] if page_size else []))
    out = capsys.readouterr().out
    assert f"artifact({ARCH}-smoke/int8)" in out
    assert "token-identical to serial decode" in out
    assert ("no prefix cache: the pattern has recurrent layers" in out) \
        == bool(page_size)
