"""The continuous-batching engine serving the xLSTM family (xlstm-1.3b) on
the CPU (the plain versions of the kernels), on the launcher's HQP
artifact of the smoke model: a pool with no KV entry at all, engine ==
serial decode bit for bit with staggered arrivals and a prefill chunk of
5 (greedy and sampled, contiguous and paged), survivors of a faulted
dispatch == serial decode, the paged engine running an empty arena as the
JAX package's does, speculative decoding, which refuses the family, a
train step, which takes it, and the launcher."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_xlstm_common import ARCH, np_tree, one_thread  # noqa: E402,F401
from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402,E501
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request, SchedulerConfig  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.serving import state_pool as sp  # noqa: E402
from repro_torch.serving.faults import inject_decode_fault  # noqa: E402
from repro_torch.serving.sampling import SamplingConfig  # noqa: E402
from repro_torch.serving.scheduler import DECODE, Action, Scheduler  # noqa: E402,E501
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402,E501
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

MAX_SEQ = 64
SAMPLED = SamplingConfig(temperature=0.8, top_k=50, seed=7)


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def setup():
    """The smoke config, its seed-0 bf16 params, and the launcher's HQP
    artifact of them at one conditional step (one of the mLSTM layer's two
    heads cut, then INT8 PTQ)."""
    cfg = configs.get_smoke_config(ARCH)
    parent = lm.init_params(cfg, seed=0, device="cpu")
    art = serve.build_artifact(parent, cfg, prune_steps=1, log=lambda s: None)
    return cfg, parent, art


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


class Interleave(Scheduler):
    """Alternates decode dispatches with prefill chunks while both are due,
    so a decode dispatch runs with a slot mid-prefill (the engine's policy
    gives prefill priority)."""
    flip = False

    def next_action(self, prefilling, decoding):
        self.flip = not self.flip
        if decoding and (self.flip or not prefilling):
            return Action(DECODE, slots=tuple(sorted(decoding)))
        return super().next_action(prefilling, ())


def _engine(params, cfg, page_size=None, n_slots=2, chunk=5,
            interleave=False, **kw):
    eng = Engine(params, cfg, n_slots=n_slots, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=chunk, decode_steps=4),
                 device="cpu", page_size=page_size, **kw)
    if interleave:
        eng.scheduler = Interleave(eng.scheduler.cfg)
    return eng


def _serial(params, cfg, prompt, n, **kw):
    return serial_decode(params, cfg, prompt, n, max_seq=MAX_SEQ,
                         device="cpu", **kw)


@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_all_recurrent_pool_has_no_kv_entry(setup, page_size):
    """Every pool entry is recurrent state (no ``k``/``k_q``): the pool's
    KV list is empty in both layouts, the KV byte count 0, and the mLSTM
    entry is sized from the artifact's cut ``in_proj`` (one head)."""
    cfg, _, art = setup
    eng = _engine(art.params, cfg, page_size)
    pool = eng.pool
    assert pool["caches"] and not sp.kv_entries(pool)
    assert all(not sp.is_kv_entry(e) for e in pool["caches"])
    assert eng.stats["kv_bytes"] == 0
    hd = cfg.d_model * 2 // cfg.n_heads
    assert pool["caches"][0]["C"].shape == (2, 1, hd, hd)
    assert pool["caches"][1]["h"].shape == (2, cfg.d_model)


@pytest.mark.parametrize("sampling", [None, SAMPLED],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_engine_equals_serial_decode(setup, page_size, sampling):
    """``tests/test_serving.py``'s xLSTM case on the port, on the INT8
    artifact: staggered arrivals into 2 slots (a slot is reused, so
    admission must zero its state), a prefill chunk of 5 that divides no
    prompt, 4 decode steps a sync: every request token-identical to
    serial decode. Paged: no prefix cache, every page back. No layer
    attends, so every dispatch keys on the whole ``max_seq`` window (one
    decode graph, not one a window bucket)."""
    cfg, _, art = setup
    prompts = _prompts(cfg, [11, 6, 17], seed=5)
    eng = _engine(art.params, cfg, page_size, sampling=sampling)
    res = eng.run([Request(prompt=p, max_new_tokens=6) for p in prompts],
                  arrival_ticks=[0, 2, 4])
    assert eng.stats["decode_ticks"] > 0 and eng.stats["prefill_ticks"] >= 3
    assert eng.graphs.keys["decode"] == {MAX_SEQ}
    assert {key[1] for key in eng.graphs.keys["prefill"]} == {MAX_SEQ}
    for i, p in enumerate(prompts):
        assert res[i].tokens == _serial(art.params, cfg, p, 6,
                                        sampling=sampling), i
    if eng.paged:
        assert eng.prefix is None and eng.stats["prefix_hits"] == 0
        eng.alloc.check()
        assert eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_decode_fault_survivors_equal_serial(setup, page_size):
    """The second decode dispatch raises: its requests end ``error``, and
    every other request, a slot mid-prefill at the fault among them, still
    equals serial decode (the fault path resets a survivor's position
    alone; its recurrent state was not written)."""
    cfg, _, art = setup
    prompts = _prompts(cfg, [6, 8, 30, 11], seed=4)
    eng = _engine(art.params, cfg, page_size, n_slots=3, chunk=4,
                  interleave=True)
    handle = inject_decode_fault(eng, at=2)
    stages = []
    absorb = eng._absorb_fault

    def noted():
        stages.append([(s.stage, s.prefill_done) for s in eng.slots])
        absorb()

    eng._absorb_fault = noted
    res = eng.run([Request(prompt=p, max_new_tokens=7) for p in prompts],
                  arrival_ticks=[0, 0, 1, 12])
    handle.restore()
    assert handle.fired == 1 and len(stages) == 1
    assert any(stage == "prefill" and done > 0 for stage, done in stages[0])
    failed = [i for i, r in res.items() if r.finish_reason == "error"]
    ok = [i for i, r in res.items() if r.finish_reason != "error"]
    assert failed and len(ok) >= 2
    for i in ok:
        assert res[i].tokens == _serial(art.params, cfg, prompts[i], 7), i


def test_paged_runs_an_empty_arena_as_the_reference():
    """The reference's engine, paged (pages of 8) on a pattern with no
    attention layer, runs with an empty KV arena (0 KV bytes) and equals
    its serial decode; the port does the same on the same weights, with no
    prefix cache, its pages all back after the run.""" 
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    prompts = _prompts(cfg, [10, 10], seed=5)
    jeng = jengine.Engine(jp, jcfg, n_slots=2, max_seq=MAX_SEQ,
                          sched=JSchedulerConfig(prefill_chunk=5),
                          page_size=8)
    jres = jeng.run([jengine.Request(prompt=p, max_new_tokens=5)
                     for p in prompts], arrival_ticks=[0, 2])
    jserial = [jengine.serial_decode(jp, jcfg, p, 5, max_seq=MAX_SEQ)
               for p in prompts]
    assert jeng.stats["kv_bytes_peak"] == 0 and jeng.stats["pages_peak"]
    assert [jres[i].tokens for i in range(2)] == jserial
    tp = from_jax_params(np_tree(jp), device="cpu")
    eng = _engine(tp, cfg, 8, prefix_cache=True)
    res = eng.run([Request(prompt=p, max_new_tokens=5) for p in prompts],
                  arrival_ticks=[0, 2])
    assert eng.prefix is None and eng.stats["kv_bytes_peak"] == 0
    assert eng.stats["pages_peak"] > 0
    eng.alloc.check()
    assert eng.alloc.pages_in_use == 0
    want = [_serial(tp, cfg, p, 5) for p in prompts]
    assert [res[i].tokens for i in range(2)] == want


# ------------------------------------------------------------------ refusals
def test_speculative_decoding_refuses_the_family(setup):
    """Speculative decoding rolls caches back by position, which recurrent
    state cannot do: the engine refuses an xLSTM verifier/drafter pair, as
    the reference's ``SpecDecoder`` does."""
    cfg, parent, art = setup
    with pytest.raises(NotImplementedError, match="recurrent"):
        _engine(parent, cfg, draft_params=art.params, spec_k=4)


def test_training_refuses_the_family():
    """Training the xLSTM family is ported (the name is this test's from
    when ``make_train_step`` refused it): a step of the smoke config is
    finite, reports the loss alone (no MoE layer) and moves the mLSTM and
    sLSTM weights."""
    cfg = configs.get_smoke_config(ARCH)
    ocfg = AdamWConfig(lr=1e-3)
    params = lm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 17)))
    new, _, m = make_train_step(cfg, ocfg, moe_no_drop=False)(
        params, adamw_init(params, ocfg), {"tokens": tokens})
    assert sorted(m) == ["loss"] and np.isfinite(float(m["loss"]))
    for i, kind in enumerate(cfg.pattern):
        w = new["blocks"][i][kind]["up" if kind == "slstm" else "in_proj"]
        w0 = params["blocks"][i][kind]["up" if kind == "slstm" else
                                       "in_proj"]
        assert torch.isfinite(w["w"].float()).all()
        assert not torch.equal(w["w"], w0["w"])


@pytest.mark.parametrize("extra", [[], ["--page-size", "16"],
                                   ["--hqp", "--prune-steps", "3"]],
                         ids=["contiguous", "paged", "hqp"])
def test_serve_cli_verifies_the_arch(capsys, extra):
    """``serve --arch xlstm-1.3b --smoke --engine --verify``: engine ==
    serial decode; paged, the summary says that the recurrent pattern runs
    without a prefix cache. With ``--hqp`` Algorithm 1 on the seed-0 smoke
    model accepts until the only mLSTM layer has no head left (2 units,
    one a step; ROADMAP C11), and the artifact still serves, its mLSTM
    block adding zeros."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
            "--tokens", "6", "--prompt-len", "9", "--max-seq", "32",
            "--verify"]
    serve.main(argv + extra)
    out = capsys.readouterr().out
    assert "token-identical to serial decode" in out
    assert ("no prefix cache: the pattern has recurrent layers" in out) \
        == ("--page-size" in extra)
    if "--hqp" in extra:
        assert f"artifact({ARCH}-smoke/int8)" in out
        assert "L0/mlstm_heads=100%" in out
