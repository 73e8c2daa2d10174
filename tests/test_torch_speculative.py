"""Self-speculative serving in the port (``repro_torch.serving.
speculative``, ``lm.verify_step``, the engine's speculative mode and its
copy-on-write) on the CPU, where the kernels run their plain versions:
greedy speculative output equals serial decode of the verifier bit for
bit in both layouts, rows that are not live keep their K/V, both pools stay
aligned, no write passes ``max_seq - 1``, and the tokens equal the JAX
package's speculative engine on the same weights up to an exact tie
there."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compress import compress as jcompress  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.serving.speculative import SpecDecoder as JSpecDecoder  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import quantize_lm_params  # noqa: E402
from repro_torch.compress.artifact import arch_fingerprint  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request, SchedulerConfig  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.serving import dispatch  # noqa: E402
from repro_torch.serving import sampling as smp  # noqa: E402
from repro_torch.serving import speculative as spec  # noqa: E402
from repro_torch.serving import state_pool as sp  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-0.6b"
MAX_SEQ = 64
CUDA = torch.device("cuda")     # a device object only: no card is touched
# f32 logits of the smoke model (|logit| <~ 1) against the JAX package's
# (the bound of tests/test_torch_model.py)
LOGIT_ATOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and under the suite's parallel workers torch's default pool (a thread
    a core in every worker) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config(ARCH)
    parent = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, parent, quantize_lm_params(parent)


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def _serial(params, cfg, prompt, n, eos=None):
    return serial_decode(params, cfg, prompt, n, max_seq=MAX_SEQ,
                         eos_id=eos, device="cpu")


# ------------------------------------------------------------ verify_step
@pytest.mark.parametrize("quantized_kv", [False, True])
def test_verify_rows_equal_one_query_prefills(setup, quantized_kv):
    """Row i of a (3, 5) verify chunk at per-slot starts 9, 20, 4 gives the
    logits and K/V of one-query prefills at start + i, bit for bit."""
    cfg, parent, draft = setup
    params = draft if quantized_kv else parent
    rng = np.random.RandomState(5)
    starts = [9, 20, 4]
    pool = sp.init_pool(cfg, 3, MAX_SEQ, params=params,
                        quantized_kv=quantized_kv, device="cpu")
    for b, st in enumerate(starts):
        prompt = torch.as_tensor(rng.randint(0, cfg.vocab_size, st))
        _, new = lm.decode_step(params, cfg, sp.gather_slot(pool, b, 0),
                                prompt[None], route="prefill")
        sp.scatter_slot(pool, b, new)
    chunk = torch.as_tensor(rng.randint(0, cfg.vocab_size, (3, 5)))
    serial = [{k: v.clone() for k, v in e.items()} for e in pool["caches"]]
    logits, new = lm.verify_step(params, cfg, pool, chunk, window=32)
    assert logits.shape == (3, 5, lm.padded_vocab(cfg))
    assert new["pos"].tolist() == [s + 5 for s in starts]
    state = {"caches": serial, "pos": torch.tensor(starts, dtype=torch.int32)}
    for i in range(5):
        one, state = lm.decode_step(params, cfg, state, chunk[:, i:i + 1],
                                    route="prefill")
        assert torch.equal(one[:, 0], logits[:, i]), i
    for got, want in zip(pool["caches"], serial):
        for key in got:
            assert torch.equal(got[key], want[key]), key


def test_verify_step_matches_reference(setup):
    """The port's verify logits against the JAX package's ``verify_step``
    on the same weights after the same prompt: within LOGIT_ATOL at every
    position."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = setup[0]
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    ctx = default_ctx()
    prompt, chunk = _prompts(cfg, [11, 5], seed=6)
    jst = jlm.init_decode_state(jcfg, 1, MAX_SEQ, ctx, params=jp)
    _, jst = jlm.decode_step(jp, jcfg, jst, np.asarray([prompt], np.int32),
                             ctx)
    want, _ = jlm.verify_step(jp, jcfg, jst, np.asarray([chunk], np.int32),
                              ctx, window=32)
    st = lm.init_decode_state(cfg, 1, MAX_SEQ, params=tp, device="cpu")
    _, st = lm.decode_step(tp, cfg, st, torch.tensor([prompt]),
                           route="prefill")
    got, _ = lm.verify_step(tp, cfg, st, torch.tensor([chunk]), window=32)
    real = slice(0, cfg.vocab_size)
    np.testing.assert_allclose(got[0, :, real].numpy(),
                               np.asarray(want)[0, :, real], rtol=0,
                               atol=LOGIT_ATOL)


# ------------------------------------------------------------ plan
def test_plan_equals_reference():
    """``plan`` caps (k, cycles) exactly as the reference's, over a grid of
    positions, capacities and budgets."""
    for k, cycles in ((1, 1), (4, 1), (4, 2), (3, 3)):
        ours = spec.SpecDecoder.__new__(spec.SpecDecoder)
        ours.k, ours.cycles = k, cycles
        ref = dataclasses.make_dataclass(
            "R", [("k", int), ("cycles", int), ("last_plan", object)])(
                k, cycles, None)
        for max_seq in (16, 64):
            for max_pos in range(0, max_seq - 1):
                for budget in (1, 2, 3, 5, 9, 40):
                    assert ours.plan(max_pos, max_seq, budget) == \
                        JSpecDecoder.plan(ref, max_pos, max_seq, budget)


# ------------------------------------------------------------ the engine
class Watch:
    """Wraps an engine's speculative dispatch: before it, snapshots both
    pools and the slots; after it, checks that rows not live kept their K/V
    and positions, that no live row's K/V before pos - 1 (the drafter's) or
    pos (the verifier's) moved, that pages no live slot owns alone are
    bit-unchanged (the prefix cache's and a copied page's sharers), and
    that both pools' positions equal the host's for every decoding slot.
    Every KV write is checked to stay within max_seq - 1 unless it is a
    parked row's (starting at or past max_seq)."""

    def __init__(self, eng, monkeypatch):
        self.eng = eng
        self.plans, self.with_prefill, self.with_free = [], 0, 0
        orig, plan = eng._spec_decode, eng.spec.plan
        monkeypatch.setattr(eng, "_spec_decode",
                            lambda ids, fin: self._wrap(orig, ids, fin))

        def record(max_pos, max_seq, budget):
            # the plan without the capacity cap, then the plan
            free = plan(max_pos, max_pos + 10 ** 6, budget)
            out = plan(max_pos, max_seq, budget)
            self.plans.append((free, out))
            assert max_pos + out[1] * (out[0] + 1) - 1 <= max_seq - 1
            return out
        monkeypatch.setattr(eng.spec, "plan", record)
        update = A.update_kv_cache
        max_seq = eng.max_seq

        def checked(cache, k_new, v_new, pos, pages=None):
            if isinstance(pos, torch.Tensor):
                start = pos.reshape(-1)
                last = start + k_new.shape[1] - 1
                assert ((start >= max_seq) | (last <= max_seq - 1)).all(), \
                    (start.tolist(), k_new.shape[1])
            return update(cache, k_new, v_new, pos, pages)
        monkeypatch.setattr(A, "update_kv_cache", checked)

    @staticmethod
    def _snap(pool):
        return [{k: v.clone() for k, v in e.items()} for e in pool["caches"]]

    def _wrap(self, orig, ids, finished):
        eng = self.eng
        pools = (eng.pool, eng.draft_pool)
        before = [self._snap(p) for p in pools]
        pos_before = [p["pos"].clone() for p in pools]
        stages = {s.idx: s.stage for s in eng.slots}
        slot_pos = {i: eng._slot_pos(eng.slots[i]) for i in ids}
        if eng.paged:
            refs = eng.alloc.refs.copy()
            owned = {p for i in ids for p in eng.slots[i].pages
                     if refs[p] == 1}
        self.with_prefill += "prefill" in stages.values()
        self.with_free += "free" in stages.values()
        orig(ids, finished)
        for pool, old, pos0, back in zip(pools, before, pos_before, (0, 1)):
            for entry, old_e in zip(pool["caches"], old):
                for key, leaf in entry.items():
                    old_leaf = old_e[key]
                    if eng.paged:
                        keep = [p for p in range(1, len(refs))
                                if refs[p] > 0 and p not in owned]
                        assert torch.equal(leaf[keep], old_leaf[keep]), key
                        continue
                    for i, stage in stages.items():
                        upto = (eng.max_seq if i not in slot_pos
                                else slot_pos[i] - back)
                        assert torch.equal(leaf[i, :upto],
                                           old_leaf[i, :upto]), (i, stage)
            for i in stages:
                if i not in slot_pos:
                    assert pool["pos"][i] == pos0[i], i
        for slot in eng.slots:
            if slot.stage == "decode":
                want = eng._slot_pos(slot)
                assert int(eng.pool["pos"][slot.idx]) == want
                assert int(eng.draft_pool["pos"][slot.idx]) == want
            elif slot.stage == "prefill":
                assert int(eng.pool["pos"][slot.idx]) == slot.prefill_done
                assert int(eng.draft_pool["pos"][slot.idx]) == \
                    slot.prefill_done


LAYOUTS = [(None, True), (None, False), (16, True), (16, False),
           (MAX_SEQ, True)]


@pytest.mark.parametrize("k,cycles", [(1, 1), (3, 2), (4, 1)])
@pytest.mark.parametrize("page_size,draft_int8", LAYOUTS,
                         ids=[f"page{p}-{'int8' if q else 'bf16'}"
                              for p, q in LAYOUTS])
def test_greedy_spec_engine_equals_serial_decode(setup, monkeypatch,
                                                 page_size, draft_int8, k,
                                                 cycles):
    """The bf16 verifier with an INT8 PTQ drafter (INT8 or bf16 drafter
    KV), staggered arrivals, a chunk (5) that divides no prompt: every
    request equals serial decode of the verifier, EOS and budgets landing
    mid-cycle included, and a prompt whose budget ends at max_seq caps
    k_eff. Dispatches ran beside free slots, whose K/V they left alone
    (``Watch``)."""
    cfg, parent, draft = setup
    # request 0 ends at max_seq while request 1, with more budget left, is
    # still live: plan() caps k_eff by capacity there
    prompts = _prompts(cfg, [52, 7, 13, 21], seed=2)
    budgets = [12, 20, 7, 9]
    eos = [None, None, None, _serial(parent, cfg, prompts[3], 9)[4]]
    eng = Engine(parent, cfg, n_slots=3, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 device="cpu", page_size=page_size, draft_params=draft,
                 spec_k=k, spec_cycles=cycles,
                 draft_quantized_kv=draft_int8)
    watch = Watch(eng, monkeypatch)
    res = eng.run([Request(prompt=p, max_new_tokens=n, eos_id=e)
                   for p, n, e in zip(prompts, budgets, eos)],
                  arrival_ticks=[0, 2, 6, 9])
    for i, p in enumerate(prompts):
        assert res[i].tokens == _serial(parent, cfg, p, budgets[i],
                                        eos[i]), i
    assert res[3].finish_reason == "eos" and len(res[3].tokens) == 5
    assert watch.with_free
    assert any(free != out for free, out in watch.plans) or k == cycles == 1
    st = eng.stats
    assert st["drafted_tokens"] > 0 and st["accepted_tokens"] > 0
    assert st["device_steps"] == sum(c * (kk + 1)
                                     for _, (kk, c) in watch.plans)
    assert eng.graphs.bounds["spec"] == (MAX_SEQ // 16) * k * cycles
    assert all(key[1:] in [out for _, out in watch.plans]
               for key in eng.graphs.keys["spec"])
    if eng.paged:
        eng.alloc.check()


@pytest.mark.parametrize("page_size", [None, 16])
def test_inactive_rows_keep_their_kv(setup, monkeypatch, page_size):
    """The scheduler never decodes while a prompt is mid-prefill, so the
    test makes that state itself: slot 0 decodes, slot 1 holds a prompt
    prefilled to position 10 (valid K/V below it, including pos - 1, where
    a live row's healing chunk writes), slot 2 is free and sits at
    position 0 (the healing chunk would write at -1). A speculative
    dispatch leaves both rows' K/V and positions as they were
    (``Watch``), and both requests still equal serial decode."""
    cfg, parent, draft = setup
    eng = Engine(parent, cfg, n_slots=3, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=5), device="cpu",
                 page_size=page_size, draft_params=draft, spec_k=4)
    watch = Watch(eng, monkeypatch)
    prompts = _prompts(cfg, [9, 23], seed=7)
    uids = {eng.submit(Request(prompt=prompts[0], max_new_tokens=10)): 0}
    eng._admit()
    finished = []
    while eng.slots[0].stage == "prefill":
        eng._prefill(eng.slots[0], finished)
    uids[eng.submit(Request(prompt=prompts[1], max_new_tokens=8))] = 1
    eng._admit()
    for _ in range(2):
        eng._prefill(eng.slots[1], finished)
    assert eng.slots[1].prefill_done == 10 and eng.slots[2].stage == "free"
    eng._decode([0], finished)
    assert watch.with_prefill == watch.with_free == 1
    while eng.has_work:
        finished += eng.step()
    for res in finished:
        i = uids[res.uid]
        assert res.tokens == _serial(parent, cfg, prompts[i],
                                     10 if i == 0 else 8), i


def _reference_logits(jp, jcfg, ctx, prompt, tokens):
    step = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    st = jlm.init_decode_state(jcfg, 1, 48, ctx, params=jp)
    logits, st = step(jp, st, np.asarray([prompt], np.int32))
    for tok in tokens:
        logits, st = step(jp, st, np.asarray([[tok]], np.int32))
    return np.asarray(logits[0, -1])[:jcfg.vocab_size]


def test_spec_engine_tokens_equal_the_reference_spec_engine():
    """The port's and the JAX package's speculative engines (bf16 verifier,
    INT8 PTQ drafter with INT8 KV, k 3), same weights, same requests: the
    same tokens up to the first difference, and there the reference holds
    an exact tie (ROADMAP C2)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jd = jcompress(jp, jcfg, log=lambda s: None).params
    ctx = default_ctx()
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    td = from_jax_params(jax.tree.map(np.asarray, jd), device="cpu")
    prompts = _prompts(cfg, [9, 14, 5], seed=3)
    sched = dict(prefill_chunk=4, decode_steps=4)
    jres = JEngine(jp, jcfg, ctx=ctx, n_slots=2, max_seq=48,
                   sched=JSchedulerConfig(**sched), draft_params=jd,
                   draft_ctx=dataclasses.replace(ctx, quantized_kv=True),
                   spec_k=3).run(
        [JRequest(prompt=p, max_new_tokens=8) for p in prompts])
    eng = Engine(tp, cfg, n_slots=2, max_seq=48,
                 sched=SchedulerConfig(**sched), device="cpu",
                 draft_params=td, spec_k=3)
    tres = eng.run([Request(prompt=p, max_new_tokens=8) for p in prompts])
    compared = 0
    for i, prompt in enumerate(prompts):
        got, want = tres[i].tokens, jres[i].tokens
        n = next((t for t in range(len(want)) if got[t] != want[t]),
                 len(want))
        compared += n
        if n < len(want):
            ref = _reference_logits(jp, jcfg, ctx, prompt, want[:n])
            assert ref.argmax() == want[n]
            assert ref[got[n]] == ref.max(), (i, n)      # an exact tie
    assert compared >= 16
    assert eng.stats["accepted_tokens"] > 0


class ReplayBody:
    """A graph that replays by running the closure captured at the key's
    second use (see tests/test_torch_dispatch.py)."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.mark.parametrize("page_size", [None, 8])
def test_spec_engine_with_replayed_captures_equals_serial(setup, monkeypatch,
                                                          page_size):
    """Every key's second-use closure replayed in place of its later
    dispatches, over two runs of one engine: token-identical to serial
    decode, with spec and spec_prefill replays (a body that took a
    per-dispatch value at capture would replay it stale)."""
    cfg, parent, draft = setup
    monkeypatch.setattr(dispatch.GraphCache, "_capture",
                        lambda self, body: (ReplayBody(body), []))
    eng = Engine(parent, cfg, n_slots=3, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 device="cpu", page_size=page_size, draft_params=draft,
                 spec_k=3)
    eng.graphs.device = CUDA
    prompts = _prompts(cfg, [13, 7, 30, 21, 9, 12], seed=2)
    want = [_serial(parent, cfg, p, 10) for p in prompts]
    for _ in range(2):
        if eng.prefix is not None:
            eng.prefix.clear()
        res = eng.run([Request(prompt=p, max_new_tokens=10)
                       for p in prompts], arrival_ticks=[0, 2, 6, 9, 10, 11])
        assert [res[i].tokens for i in range(len(prompts))] == want
    captured = {kind for kind, _ in eng.graphs._graphs}
    assert captured == {"spec", "spec_prefill"}
    assert eng.stats["graph_replays"] > len(eng.graphs._graphs)


# ------------------------------------------------------------ sampling
def test_sampled_spec_is_deterministic_and_counts_acceptance(setup):
    """Temperature 0.8, top-k 50, seed 7: two speculative engines give the
    same tokens, whose first equals sampled serial decode's (the verifier's
    prefill draws it with the same key); the stats give the acceptance rate
    in the speculative and the plain mode."""
    cfg, parent, draft = setup
    scfg = smp.SamplingConfig(temperature=0.8, top_k=50, seed=7)
    prompts = _prompts(cfg, [13, 7, 30], seed=4)
    runs = []
    for _ in range(2):
        eng = Engine(parent, cfg, n_slots=3, max_seq=MAX_SEQ,
                     sched=SchedulerConfig(prefill_chunk=5), device="cpu",
                     draft_params=draft, spec_k=4, sampling=scfg)
        res = eng.run([Request(prompt=p, max_new_tokens=12)
                       for p in prompts], arrival_ticks=[0, 1, 3])
        runs.append(([res[i].tokens for i in range(3)], dict(eng.stats)))
    assert runs[0] == runs[1]
    toks, st = runs[0]
    for p, t in zip(prompts, toks):
        assert t[0] == serial_decode(parent, cfg, p, 1, max_seq=MAX_SEQ,
                                     device="cpu", sampling=scfg)[0]
    assert 0 < st["accepted_tokens"] <= st["drafted_tokens"]
    assert st["accepted_tokens"] <= 3 * 11
    plain = Engine(parent, cfg, n_slots=3, max_seq=MAX_SEQ, device="cpu",
                   sampling=scfg)
    plain.run([Request(prompt=p, max_new_tokens=12) for p in prompts])
    ps = plain.stats
    assert ps["accepted_tokens"] == 3 * 11 == ps["decode_slot_steps"]
    assert ps["drafted_tokens"] >= ps["accepted_tokens"]


def test_acceptance_reproduces_the_verifier_distribution():
    """Rejection sampling on a toy vocabulary of 5 with p != q: the drafter
    draws d ~ q with its keys, ``accept_sampled`` keeps it or resamples; over
    20,000 keyed rows the first emitted token's frequency is within 4 sigma
    of p for every token."""
    n, v = 20_000, 5
    p = torch.tensor([0.05, 0.40, 0.25, 0.20, 0.10])
    q = torch.tensor([0.30, 0.10, 0.25, 0.05, 0.30])
    base = smp.base_key(smp.SamplingConfig(temperature=1.0, seed=11))
    pos = torch.arange(n) * 7
    d = smp.sample_batch(torch.log(q).expand(n, v),
                         smp.SamplingConfig(temperature=1.0), base, pos + 1)
    n_acc, corr = spec.accept_sampled(p.expand(n, 2, v), q.expand(n, 1, v),
                                      d[:, None], pos, base)
    first = torch.where(n_acc > 0, d, corr[:, 0])
    freq = torch.bincount(first, minlength=v).double() / n
    sigma = torch.sqrt(p.double() * (1 - p.double()) / n)
    assert (torch.abs(freq - p.double()) <= 4 * sigma).all(), (freq, p)
    # q alone would be far off p: the check has power
    assert (torch.abs(q.double() - p.double()) > 4 * sigma).any()


# ------------------------------------------------------------ copy-on-write
def test_copy_on_write_keeps_the_cached_page(setup):
    """A 32-token prompt (two pages of 16) goes into the prefix cache; the
    first speculative dispatch's healing chunk writes at position 31, in
    the cached page: the page is copied in both arenas, the cached one stays
    bit-unchanged through later requests that hit the head (and equal
    serial decode), and no page leaks."""
    cfg, parent, draft = setup
    head = _prompts(cfg, [32], seed=8)[0]
    eng = Engine(parent, cfg, n_slots=2, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=8), device="cpu",
                 page_size=16, draft_params=draft, spec_k=3)
    first = eng.run([Request(prompt=head, max_new_tokens=6)])
    assert first[0].tokens == _serial(parent, cfg, head, 6)
    assert eng.stats["cow_copies"] == 1
    key = np.asarray(head, np.int64).tobytes()
    cached = eng.prefix._entries[key]
    snap = [[{k: v[cached].clone() for k, v in e.items()}
             for e in pool["caches"]] for pool in (eng.pool, eng.draft_pool)]
    tail = _prompts(cfg, [5], seed=9)[0]
    res = eng.run([Request(prompt=head + tail, max_new_tokens=6),
                   Request(prompt=head, max_new_tokens=6)])
    assert res[0].tokens == _serial(parent, cfg, head + tail, 6)
    assert res[1].tokens == first[0].tokens
    assert eng.stats["prefix_hits"] == 2
    # the repeat hits one page and prefills its second into a page of its
    # own (the cache keeps the first copy): nothing shared to copy
    assert eng.stats["cow_copies"] == 1
    for pool, old in zip((eng.pool, eng.draft_pool), snap):
        for entry, old_e in zip(pool["caches"], old):
            for k, leaf in entry.items():
                assert torch.equal(leaf[cached], old_e[k]), k
    eng.alloc.check()
    eng.prefix.clear()
    assert eng.alloc.pages_in_use == 0
    eng.alloc.check()


# ------------------------------------------------------------ refusals
def test_refusals(setup):
    """A drafter built for another architecture or vocabulary, k < 1 and
    cycles < 1 are refused before any device work."""
    cfg, parent, draft = setup

    @dataclasses.dataclass
    class Manifest:
        arch: str
        arch_hash: object
        vocab_size: object

    good = Manifest(cfg.name, arch_fingerprint(cfg), cfg.vocab_size)
    spec.check_drafter_compat(cfg, good)
    spec.check_drafter_compat(cfg, None)
    other = dataclasses.replace(cfg, d_model=128)
    for bad, match in ((dataclasses.replace(good, arch_hash=arch_fingerprint(
            other)), "arch_hash"),
                       (dataclasses.replace(good, arch_hash=None,
                                            vocab_size=300), "vocab_size")):
        with pytest.raises(ValueError, match=match):
            Engine(parent, cfg, device="cpu", draft_params=draft,
                   draft_manifest=bad)
    with pytest.raises(ValueError, match="k must be >= 1"):
        Engine(parent, cfg, device="cpu", draft_params=draft, spec_k=0)
    with pytest.raises(ValueError, match="cycles must be >= 1"):
        Engine(parent, cfg, device="cpu", draft_params=draft, spec_cycles=0)


def test_serve_cli_speculative(capsys):
    """``serve --engine --hqp --spec-k 4 --verify`` equals serial decode of
    the bf16 parent; a sampled speculative run skips the check and says
    why; --spec-k without --engine or without a drafter is refused."""
    base = ["--smoke", "--device", "cpu", "--tokens", "8", "--prompt-len",
            "9", "--max-seq", "32", "--prune-steps", "1"]
    stats = serve.main(base + ["--engine", "--hqp", "--spec-k", "4",
                               "--verify"])
    out = capsys.readouterr().out
    assert "token-identical to serial decode" in out
    assert "spec acceptance" in out and stats["drafted_tokens"] > 0
    serve.main(base + ["--engine", "--hqp", "--spec-k", "3",
                       "--temperature", "0.8", "--top-k", "50", "--seed",
                       "7", "--verify"])
    assert "verify skipped" in capsys.readouterr().out
    for argv in (["--hqp", "--spec-k", "4"], ["--engine", "--spec-k", "4"]):
        with pytest.raises(SystemExit):
            serve.main(base + argv)
    assert "--spec-k needs" in capsys.readouterr().err
