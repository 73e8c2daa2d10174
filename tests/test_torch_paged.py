"""The port's paged KV path on the CPU (plain versions of the kernels), held
against the JAX package on the same numpy inputs: the page math and the
allocator / prefix-cache state exactly, paged attention within the stated
attention tolerance, and the paged engine token for token, against serial
decode inside the port and against the JAX package's paged engine.

Tolerances: as ``test_torch_kernels.py``. Attention vs the xla oracle: one
bf16 ulp of outputs of magnitude <~ 4 (atol 1.6e-2, rtol 2^-7); vs the
Pallas kernels in interpret mode (online softmax, p kept in f32): rtol and
atol 3e-2. Inside the port, paged equals contiguous bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compress import compress  # noqa: E402
from repro.kernels import decode_attention as jdec  # noqa: E402
from repro.kernels import kv_layout as jkv  # noqa: E402
from repro.kernels import prefill_attention as jpre  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.serving import state_pool as jsp  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import quantize_lm_params  # noqa: E402
from repro_torch.kernels import kv_layout as kv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.serving import SchedulerConfig, serial_decode  # noqa: E402
from repro_torch.serving import state_pool as sp  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-0.6b"
MAX_SEQ = 64
ATTN_REF = dict(rtol=2 ** -7, atol=1.6e-2)
ATTN_PALLAS = dict(rtol=3e-2, atol=3e-2)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _table(rng, b, n_pages, max_pages, mapped):
    """(b, max_pages) int32 table: row i maps ``mapped[i]`` distinct pages
    drawn from a random permutation of 1..n_pages-1; the rest point at the
    trash page 0."""
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tab = np.zeros((b, max_pages), np.int32)
    used = 0
    for i, n in enumerate(mapped):
        tab[i, :n] = perm[used:used + n]
        used += n
    return tab


# ---------------------------------------------------------------- page math
@pytest.mark.parametrize("seed,page_size", [(0, 4), (1, 8), (2, 16)])
def test_kv_layout_equals_reference(seed, page_size):
    rng = np.random.RandomState(seed)
    b, max_pages, n_pages = 3, 6, 20
    tab = _table(rng, b, n_pages, max_pages, [6, 3, 1])
    tt, tj = torch.from_numpy(tab), jnp.asarray(tab)
    for tokens in (0, 1, page_size - 1, page_size, 5 * page_size + 3):
        assert kv.page_count(tokens, page_size) == jkv.page_count(
            tokens, page_size)
    for window in (None, 1, page_size, 3 * page_size - 1, 100 * page_size):
        np.testing.assert_array_equal(
            kv.window_pages(tt, page_size, window).numpy(),
            np.asarray(jkv.window_pages(tj, page_size, window)))
    # a negative position (an inactive row's stray write) clamps into the
    # row's first table entry
    pos = np.asarray([-3, 5, 2 * page_size - 1], np.int32)
    for sn in (1, 4):
        np.testing.assert_array_equal(
            kv.paged_element_index(tt, torch.from_numpy(pos), sn,
                                   page_size).numpy(),
            np.asarray(jkv.paged_element_index(tj, jnp.asarray(pos), sn,
                                               page_size)))
    leaf = rng.randint(-127, 128, (n_pages, page_size, 2, 4)).astype(np.int8)
    np.testing.assert_array_equal(
        kv.gather_pages(torch.from_numpy(leaf), tt[:, :4]).numpy(),
        np.asarray(jkv.gather_pages(jnp.asarray(leaf), tj[:, :4])))
    upd = rng.randint(-127, 128, (b, 4, 2, 4)).astype(np.int8)
    pos = np.asarray([1, 0, page_size - 2], np.int32)
    got = kv.scatter_pages(torch.from_numpy(leaf.copy()),
                           torch.from_numpy(upd), tt, torch.from_numpy(pos))
    want = jkv.scatter_pages(jnp.asarray(leaf), jnp.asarray(upd), tj,
                             jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- paged attention
B, HQ, HKV, HD = 3, 8, 4, 32


def _arena(rng, n_pages, page_size, quantized):
    """The same paged arena in both frameworks: bf16 K/V, or int8 K/V with
    f32 scales."""
    shape = (n_pages, page_size, HKV, HD)
    if quantized:
        arrays = {"k_q": rng.randint(-127, 128, shape).astype(np.int8),
                  "v_q": rng.randint(-127, 128, shape).astype(np.int8),
                  "k_s": (rng.rand(*shape[:3]) * 0.02 + 0.005
                          ).astype(np.float32),
                  "v_s": (rng.rand(*shape[:3]) * 0.02 + 0.005
                          ).astype(np.float32)}
        return ({k: jnp.asarray(a) for k, a in arrays.items()},
                {k: torch.from_numpy(a) for k, a in arrays.items()})
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return ({"k": jnp.asarray(k, jnp.bfloat16),
             "v": jnp.asarray(v, jnp.bfloat16)},
            {"k": torch.from_numpy(k).to(torch.bfloat16),
             "v": torch.from_numpy(v).to(torch.bfloat16)})


def _leaves_j(cache):
    if "k_q" in cache:
        return cache["k_q"], cache["v_q"], cache["k_s"], cache["v_s"]
    return cache["k"], cache["v"], None, None


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("sq", [1, 5])
def test_paged_attention_vs_reference_and_pallas(quantized, page_size, sq):
    """Rows map a random permutation of the arena's pages; entries past a
    row's limit point at the trash page. sq == 1 is the decode op, sq == 5
    a ragged prefill chunk."""
    rng = np.random.RandomState(page_size + sq + quantized)
    n_pages, max_pages = 24, 64 // page_size
    starts = np.asarray([0, 29, 64 - sq], np.int32)
    mapped = [kv.page_count(int(s) + sq, page_size) for s in starts]
    tab = _table(rng, B, n_pages, max_pages, mapped)
    cj, ct = _arena(rng, n_pages, page_size, quantized)
    q = rng.randn(B, sq, HQ, HD).astype(np.float32)
    qj, qt = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(
        torch.bfloat16)
    st, tt = torch.from_numpy(starts), torch.from_numpy(tab)
    window = 48 if sq == 1 else None       # a window that cuts the table
    if sq == 1:
        starts = np.minimum(starts, 40)
        st = torch.from_numpy(starts)
        out = ops.decode_attention(qt, ct, st, window, tt)[:, 0]
    else:
        out = ops.prefill_attention(qt, ct, st, window, tt)
    idx = kv.window_pages(tt, page_size, window)
    idx_j = jnp.asarray(idx.numpy())
    k, v, ks, vs = _leaves_j(cj)
    if sq == 1:
        want = jref.paged_decode_attention_ref(qj[:, 0], k, v, ks, vs,
                                               jnp.asarray(starts), idx_j)
        pallas = jdec.paged_decode_attention_pallas(
            qj[:, 0], k, v, ks, vs, jnp.asarray(starts), idx_j,
            interpret=True)
    else:
        want = jref.paged_prefill_attention_ref(qj, k, v, ks, vs,
                                                jnp.asarray(starts), idx_j)
        pallas = jpre.paged_prefill_attention_pallas(
            qj, k, v, ks, vs, jnp.asarray(starts), idx_j, bq=4,
            interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(want), **ATTN_REF)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **ATTN_PALLAS)
    # inside the port: paged == contiguous on the gathered window, bitwise
    gathered = {key: kv.gather_pages(leaf, idx) for key, leaf in ct.items()}
    if sq == 1:
        contiguous = ops.decode_attention(qt, gathered, st)[:, 0]
    else:
        contiguous = ops.prefill_attention(qt, gathered, st)
    assert torch.equal(out, contiguous)


def test_paged_refs_are_gather_then_contiguous():
    rng = np.random.RandomState(7)
    _, ct = _arena(rng, 10, 8, True)
    tab = torch.from_numpy(_table(rng, B, 10, 4, [4, 2, 1]))
    q = torch.from_numpy(rng.randn(B, 3, HQ, HD)).to(torch.bfloat16)
    start = torch.tensor([20, 5, 0], dtype=torch.int32)
    k, v, ks, vs = ct["k_q"], ct["v_q"], ct["k_s"], ct["v_s"]
    g = lambda t: kv.gather_pages(t, tab)
    assert torch.equal(
        ref.paged_prefill_attention_ref(q, k, v, ks, vs, start, tab),
        ref.cached_attention_ref(q, g(k), g(v), g(ks), g(vs), start))
    assert torch.equal(
        ref.paged_decode_attention_ref(q[:, 0], k, v, ks, vs, start, tab),
        ref.decode_attention_ref(q[:, 0], g(k), g(v), g(ks), g(vs), start))


# ------------------------------------------------ allocator / prefix cache
def _same_allocators(a, ja):
    np.testing.assert_array_equal(a.refs, ja.refs)
    assert a._free == ja._free
    assert a.pages_in_use == ja.pages_in_use
    a.check()
    ja.check()


def test_page_allocator_exhaustion_and_reuse():
    for mod in (sp, jsp):
        alloc = mod.PageAllocator(5)              # trash + 4 usable
        a = alloc.alloc(4)
        assert sorted(a) == [1, 2, 3, 4] and alloc.free_pages == 0
        with pytest.raises(MemoryError):
            alloc.alloc(1)
        alloc.unref([a[0]])
        assert alloc.alloc(1) == [a[0]]           # freed page comes back
        alloc.check()


def test_prefix_cache_longest_aligned_proper_prefix():
    for mod in (sp, jsp):
        alloc = mod.PageAllocator(9)
        cache = mod.PrefixCache(alloc, page_size=4)
        prompt = np.arange(12, dtype=np.int32)
        pages = alloc.alloc(3)
        assert cache.insert(prompt, pages, 12) == 12
        # exact repeat: the hit caps at 8 tokens so one token prefills
        hit, got = cache.lookup(prompt)
        assert hit == 8 and got == pages[:2]
        alloc.unref(got)
        hit, got = cache.lookup(np.arange(14, dtype=np.int32))
        assert hit == 12 and got == pages
        alloc.unref(got)
        assert cache.lookup(np.full(12, 99, np.int32)) == (0, [])
        cache.clear()
        alloc.unref(pages)
        assert alloc.pages_in_use == 0
        alloc.check()


def test_prefix_cache_lru_eviction_unrefs():
    for mod in (sp, jsp):
        alloc = mod.PageAllocator(9)
        cache = mod.PrefixCache(alloc, page_size=4)
        p1, p2 = alloc.alloc(1), alloc.alloc(1)
        cache.insert(np.arange(4, dtype=np.int32), p1, 4)
        cache.insert(np.arange(10, 14, dtype=np.int32), p2, 4)
        alloc.unref(p1 + p2)                      # the cache holds the refs
        assert alloc.pages_in_use == 2
        assert cache.evict_lru()                  # the p1 entry, the oldest
        assert alloc.refs[p1[0]] == 0 and alloc.refs[p2[0]] == 1
        assert cache.evict_lru() and not cache.evict_lru()
        assert alloc.pages_in_use == 0
        alloc.check()


@pytest.mark.parametrize("seed", range(4))
def test_page_allocator_sequences_equal_reference(seed):
    """Random alloc / ref / unref interleavings on both packages' allocators
    keep equal refcounts and free lists at every step, and draining every
    reference empties both arenas."""
    rng = np.random.RandomState(seed)
    pair = (sp.PageAllocator(9), jsp.PageAllocator(9))
    live = {}                                     # page -> refs held
    for _ in range(40):
        op, n = rng.randint(3), rng.randint(1, 5)
        if op == 0:
            try:
                got = [a.alloc(n) for a in pair]
            except MemoryError:
                assert all(a.free_pages < n for a in pair)
                continue
            assert got[0] == got[1] and not set(got[0]) & set(live)
            live.update({p: 1 for p in got[0]})
        elif live:
            pages = sorted(live)[:n]
            for a in pair:
                (a.ref if op == 1 else a.unref)(pages)
            for p in pages:
                live[p] += 1 if op == 1 else -1
                if not live[p]:
                    del live[p]
        _same_allocators(*pair)
        assert pair[0].pages_in_use == len(live)
    for p, r in live.items():
        for a in pair:
            a.unref([p] * r)
    _same_allocators(*pair)
    assert pair[0].pages_in_use == 0


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_sequences_equal_reference(seed):
    """Random insert / lookup / release / evict interleavings of slots over
    both packages' prefix caches: equal lookups, refcounts and free lists
    at every step, a hit is always a prefix of the inserting slot's pages,
    and releasing every slot plus clearing the cache empties both arenas."""
    rng = np.random.RandomState(seed)
    ps = 4
    allocs = (sp.PageAllocator(12), jsp.PageAllocator(12))
    caches = (sp.PrefixCache(allocs[0], ps), jsp.PrefixCache(allocs[1], ps))
    inserted, held, base = [], [], 0
    for _ in range(30):
        op, n = rng.randint(4), rng.randint(1, 4)
        if op == 0:                               # prefill a prompt, insert
            got = []
            for a, c in zip(allocs, caches):      # evict-then-retry
                while True:
                    try:
                        got.append(a.alloc(n))
                        break
                    except MemoryError:
                        if not c.evict_lru():
                            got.append(None)
                            break
            assert got[0] == got[1]
            if got[0] is None:
                continue
            prompt = np.arange(base, base + n * ps, dtype=np.int32)
            base += n * ps
            assert [c.insert(prompt, got[0], n * ps)
                    for c in caches] == [n * ps] * 2
            inserted.append((prompt, got[0]))
            held.append(got[0])
        elif op == 1 and inserted:                # a later prompt shares it
            prompt, pages = inserted[n % len(inserted)]
            probe = np.concatenate([prompt, np.full(2, -1, np.int32)])
            hits = [c.lookup(probe) for c in caches]
            assert hits[0] == hits[1]
            if hits[0][0]:
                assert hits[0][1] == list(pages[:hits[0][0] // ps])
                held.append(hits[0][1])
        elif op == 2 and held:                    # a slot finishes
            pages = held.pop(n % len(held))
            for a in allocs:
                a.unref(pages)
        elif op == 3:                             # arena pressure
            assert caches[0].evict_lru() == caches[1].evict_lru()
        _same_allocators(*allocs)
    for pages in held:
        for a in allocs:
            a.unref(pages)
    for c in caches:
        c.clear()
    _same_allocators(*allocs)
    assert allocs[0].pages_in_use == 0 and allocs[0].free_pages == 11


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config(ARCH)
    params = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, {"fp": (params, False),
                 "hqp": (quantize_lm_params(params), True)}


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def _assert_drained(eng):
    """Every slot is evicted: the only live references are the prefix
    cache's, and the allocator invariants hold."""
    cache_pages = (len({p for v in eng.prefix._entries.values() for p in v})
                   if eng.prefix is not None else 0)
    assert eng.alloc.pages_in_use == cache_pages
    eng.alloc.check()


@pytest.mark.parametrize("kind", ["fp", "hqp"])
@pytest.mark.parametrize("page_size", [16, 32, MAX_SEQ])
def test_paged_engine_equals_serial_decode(setup, kind, page_size):
    """Ragged prompts, staggered arrivals, a chunk (5) that divides no
    prompt: token-identical to serial decode at a multi-page, a mid and the
    one-page-per-slot page size, with bf16 (fp) and INT8 (hqp) KV."""
    cfg, models = setup
    params, qkv = models[kind]
    prompts = _prompts(cfg, [13, 7, 30, 21], seed=2)
    eng = Engine(params, cfg, n_slots=3, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 quantized_kv=qkv, device="cpu", page_size=page_size)
    res = eng.run([Request(prompt=p, max_new_tokens=10) for p in prompts],
                  arrival_ticks=[0, 2, 6, 9])
    for i, p in enumerate(prompts):
        assert res[i].tokens == serial_decode(
            params, cfg, p, 10, max_seq=MAX_SEQ, quantized_kv=qkv,
            device="cpu"), (page_size, i)
    assert eng.stats["pages_peak"] <= eng.total_pages - 1
    _assert_drained(eng)


@pytest.mark.parametrize("kind", ["fp", "hqp"])
def test_prefix_reuse_skips_prefill_and_stays_identical(setup, kind):
    """A repeated page-aligned head: later admissions map the cached pages
    without a copy and prefill only their tails, and the tokens still equal
    serial decode. With the prefix cache off, the same run hits nothing
    and returns every page."""
    cfg, models = setup
    params, qkv = models[kind]
    rng = np.random.RandomState(5)
    head = rng.randint(0, cfg.vocab_size, 32).tolist()
    reqs = [Request(prompt=head + rng.randint(0, cfg.vocab_size, 5).tolist(),
                    max_new_tokens=4) for _ in range(4)]
    want = [serial_decode(params, cfg, r.prompt, 4, max_seq=MAX_SEQ,
                          quantized_kv=qkv, device="cpu") for r in reqs]
    for prefix_cache in (True, False):
        eng = Engine(params, cfg, n_slots=2, max_seq=MAX_SEQ,
                     sched=SchedulerConfig(prefill_chunk=8),
                     quantized_kv=qkv, device="cpu", page_size=16,
                     prefix_cache=prefix_cache)
        res = eng.run(reqs)
        assert [res[i].tokens for i in range(len(reqs))] == want
        st = eng.stats
        n_prompt = sum(len(r.prompt) for r in reqs)
        if prefix_cache:
            # two slots admit the first two requests before either
            # inserts, so the later two hit
            assert st["prefix_hits"] == 2
            assert st["prefix_hit_tokens"] == 2 * 32
            assert st["bytes_saved"] > 0
            assert st["prefill_tokens"] == n_prompt - 2 * 32
            _assert_drained(eng)
            eng.prefix.clear()
            assert eng.alloc.pages_in_use == 0
        else:
            assert st["prefix_hits"] == 0
            assert st["prefill_tokens"] == n_prompt
            assert eng.alloc.pages_in_use == 0
            eng.alloc.check()


def test_paged_reset_slot_leaves_the_arena_alone(setup):
    cfg, models = setup
    params, _ = models["hqp"]
    pool = sp.init_paged_pool(cfg, 2, 32, page_size=16, total_pages=5,
                              params=params, quantized_kv=True, device="cpu")
    for entry in pool["caches"]:
        for leaf in entry.values():
            leaf.copy_(torch.randint(-5, 6, leaf.shape).to(leaf.dtype))
    before = [{k: t.clone() for k, t in e.items()} for e in pool["caches"]]
    sp.reset_slot(pool, 1, 3)
    assert int(pool["pos"][1]) == 3 and int(pool["pos"][0]) == 0
    for a, b in zip(before, pool["caches"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def _reference_logits(jp, jcfg, ctx, prompt, tokens):
    """The JAX package's serial logits for the token after prompt+tokens."""
    step = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    st = jlm.init_decode_state(jcfg, 1, 48, ctx, params=jp)
    logits, st = step(jp, st, np.asarray([prompt], np.int32))
    for tok in tokens:
        logits, st = step(jp, st, np.asarray([[tok]], np.int32))
    return np.asarray(logits[0, -1])[:jcfg.vocab_size]


@pytest.mark.parametrize("kind", ["fp", "ptq"])
def test_paged_engine_tokens_equal_the_reference_paged_engine(kind):
    """The port's paged engine and the JAX package's, same weights, same
    requests (two share a 16-token head, so the prefix cache is used): the
    same tokens, under the exact-tie rule of
    ``test_torch_serving.py::test_engine_tokens_equal_the_reference_engine``
    (where the two first differ, the reference must hold an exact tie)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    ctx = default_ctx()
    if kind == "ptq":
        jp = compress(jp, jcfg, log=lambda s: None).params
        ctx = dataclasses.replace(ctx, quantized_kv=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    head, tails = _prompts(cfg, [16], seed=8)[0], _prompts(cfg, [3, 7, 5],
                                                          seed=9)
    prompts = [head + tails[0], tails[1], head + tails[2]]
    sched = dict(prefill_chunk=4, decode_steps=4)
    jeng = JEngine(jp, jcfg, ctx=ctx, n_slots=2, max_seq=48,
                   sched=JSchedulerConfig(**sched), page_size=16)
    jres = jeng.run([JRequest(prompt=p, max_new_tokens=8) for p in prompts])
    teng = Engine(tp, cfg, n_slots=2, max_seq=48,
                  sched=SchedulerConfig(**sched),
                  quantized_kv=ctx.quantized_kv, device="cpu", page_size=16)
    tres = teng.run([Request(prompt=p, max_new_tokens=8) for p in prompts])
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 1
    compared = 0
    for i, prompt in enumerate(prompts):
        got, want = tres[i].tokens, jres[i].tokens
        n = next((t for t in range(len(want)) if got[t] != want[t]),
                 len(want))
        compared += n
        if n < len(want):
            ref_logits = _reference_logits(jp, jcfg, ctx, prompt, want[:n])
            assert ref_logits.argmax() == want[n]
            assert ref_logits[got[n]] == ref_logits.max(), (i, n)
    assert compared >= 16


def test_serve_cli_paged_engine_verifies_on_cpu(capsys):
    stats = serve.main(["--smoke", "--device", "cpu", "--engine", "--hqp",
                        "--page-size", "16", "--tokens", "6",
                        "--prompt-len", "9", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "token-identical to serial decode" in out
    assert "pages peak" in out and stats["pages_peak"] > 0
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--page-size", "16"])
