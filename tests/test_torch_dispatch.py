"""The engine's compiled dispatch (``repro_torch.serving.dispatch``) on the
CPU: what a CUDA graph of a dispatch bakes in must not change between
dispatches of one key, prefill from the pool's device position equals
prefill from the host's int bit for bit, the graph cache's policy (eager
first use, capture at the second, replay after; bounded keys; launch
counts of the device) with a fake graph in place of ``torch.cuda.
CUDAGraph``, and the key bounds and key counts against the JAX package's
jitted dispatches."""
import collections
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.analysis.invariants import spec_of  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import quantize_lm_params  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.kv_layout import page_count  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request, SchedulerConfig  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.serving import dispatch  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import state_pool as sp  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-0.6b"
CUDA = torch.device("cuda")     # a device object only: no card is touched


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config(ARCH)
    params = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, {"fp": (params, False),
                 "hqp": (quantize_lm_params(params), True)}


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


# ------------------------------------------------ prefill from the device
@pytest.mark.parametrize("page_size", [None, 8])
@pytest.mark.parametrize("kind", ["fp", "hqp"])
def test_prefill_from_device_position_equals_host_int(setup, kind,
                                                      page_size):
    """A prompt prefilled in chunks of 5 into slot 1, once from the host's
    int position and once from the pool's device position (a view of
    ``pool["pos"]``; paged: gathered through a (1,) slot index tensor, the
    position written back in place): the same logits and the same KV, bit
    for bit (tolerance 0), and at every chunk end the logits of a
    whole-prompt prefill of the same prefix. bf16 (fp) and INT8 (hqp) KV,
    contiguous and paged (pages of 8, a scattered table)."""
    cfg, models = setup
    params, qkv = models[kind]
    max_seq = 48
    prompt = torch.tensor(_prompts(cfg, [23], seed=4)[0])
    if page_size:
        pools = [sp.init_paged_pool(cfg, 2, max_seq, page_size=page_size,
                                    total_pages=14, params=params,
                                    quantized_kv=qkv, device="cpu")
                 for _ in range(2)]
        table = np.zeros((2, page_count(max_seq, page_size)), np.int32)
        table[1] = [9, 2, 12, 5, 7, 3]
    else:
        pools = [sp.init_pool(cfg, 2, max_seq, params=params,
                              quantized_kv=qkv, device="cpu")
                 for _ in range(2)]
    host_pool, dev_pool = pools
    slot = torch.tensor([1]) if page_size else 1
    for lo in range(0, 23, 5):
        hi = min(23, lo + 5)
        window = -(-hi // 16) * 16
        row = (torch.from_numpy(
            table[1:2, :page_count(window, page_size)].copy())
            if page_size else None)
        chunk = prompt[None, lo:hi]
        want, new = lm.decode_step(
            params, cfg, sp.gather_slot(host_pool, 1, lo, pages=row), chunk,
            window=window, route="prefill")
        sp.scatter_slot(host_pool, 1, new)
        got, new = lm.decode_step(
            params, cfg, sp.gather_slot(dev_pool, slot, pages=row), chunk,
            window=window, route="prefill")
        sp.scatter_slot(dev_pool, slot, new)
        assert torch.equal(got, want), (lo, hi)
        whole, _ = lm.decode_step(
            params, cfg, lm.init_decode_state(cfg, 1, max_seq, params=params,
                                              quantized_kv=qkv, device="cpu"),
            prompt[None, :hi], route="prefill")
        assert torch.equal(got, whole), (lo, hi)
    assert dev_pool["pos"].tolist() == host_pool["pos"].tolist() == [0, 23]
    for a, b in zip(host_pool["caches"], dev_pool["caches"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------ fixed addresses per key
@pytest.mark.parametrize("page_size", [None, 8])
def test_dispatch_inputs_keep_their_addresses_per_key(setup, monkeypatch,
                                                      page_size):
    """Across a whole engine run (staggered arrivals, ragged chunks, windows
    over several buckets), every tensor a graph of a dispatch would bake in
    keeps its address from dispatch to dispatch of one key: the decode
    inputs (tokens, live, EOS, left), ``pool["pos"]`` (the same object all
    run long), the page table per width, the chunk, the prefill position
    and, paged, the slot's table row and index, and the rows of the decode
    table that are not decoding point at the trash page. On the CPU every
    dispatch runs eagerly and nothing is captured."""
    cfg, models = setup
    params, qkv = models["hqp"]
    eng = Engine(params, cfg, n_slots=3, max_seq=64,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 quantized_kv=qkv, device="cpu", page_size=page_size)
    pos = eng.pool["pos"]
    pos_ptr = pos.data_ptr()
    seen, current, uses = {}, {}, collections.Counter()
    trashed = [0]
    run, decode_step, gather_slot = (dispatch.GraphCache.run, lm.decode_step,
                                     sp.gather_slot)

    def spy_run(self, kind, key, body):
        current.update(key=(kind, key), calls=0)
        uses[(kind, key)] += 1
        return run(self, kind, key, body)

    def spy_gather(pool, slot, pos=None, pages=None):
        if isinstance(slot, torch.Tensor):
            current["slot"] = slot.data_ptr()
        return gather_slot(pool, slot, pos, pages)

    def spy_step(p, c, state, tokens, window=None, route=None):
        if current["calls"] == 0:
            assert state["pos"] is pos or route == "prefill"
            if route == "decode" and "pages" in state:
                # rows not decoding (free, mid-prefill) write to the trash
                idle = [s.idx for s in eng.slots if s.stage != "decode"]
                assert bool((state["pages"][idle] == sp.TRASH_PAGE).all())
                trashed[0] += len(idle)
            ptrs = (tokens.data_ptr(),
                    None if "slot" in current
                    else state["pos"].data_ptr(),
                    None if "pages" not in state
                    else state["pages"].data_ptr(),
                    current.pop("slot", None))
            seen.setdefault(current["key"], set()).add(ptrs)
        current["calls"] += 1
        return decode_step(p, c, state, tokens, window, route)

    monkeypatch.setattr(dispatch.GraphCache, "run", spy_run)
    monkeypatch.setattr(sp, "gather_slot", spy_gather)
    monkeypatch.setattr(engine_mod.lm, "decode_step", spy_step)
    prompts = _prompts(cfg, [13, 7, 30, 21, 9], seed=2)
    eng.run([Request(prompt=p, max_new_tokens=12) for p in prompts],
            arrival_ticks=[0, 2, 6, 9, 10])
    assert eng.pool["pos"] is pos and pos.data_ptr() == pos_ptr
    assert trashed[0] > 0 or page_size is None
    for key, ptrs in seen.items():
        assert len(ptrs) == 1, (key, ptrs)
    assert {kind for (kind, _), n in uses.items() if n > 1} \
        == {"decode", "prefill"}
    st = eng.stats
    assert st["graphs_captured"] == st["graph_replays"] == 0
    assert st["eager_dispatches"] == st["prefill_ticks"] + st["decode_ticks"]
    assert st["decode_ticks"] > len(eng.graphs.keys["decode"])
    assert st["prefill_ticks"] > len(eng.graphs.keys["prefill"])


# ------------------------------------------------ the graph cache's policy
class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records its capture and its
    replays."""
    capturing = False
    made = []

    def __init__(self):
        self.replays = 0
        self.pool = None
        FakeGraph.made.append(self)

    def capture_begin(self, pool=None, **_):
        FakeGraph.capturing = True
        self.pool = pool

    def capture_end(self):
        FakeGraph.capturing = False

    def replay(self):
        assert not FakeGraph.capturing
        self.replays += 1


@contextlib.contextmanager
def _fake_capture(graph, pool=None):
    graph.capture_begin(pool)
    try:
        yield
    finally:
        graph.capture_end()


@pytest.fixture
def fake_graphs(monkeypatch):
    FakeGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    # the pool grows by 4 KiB a graph captured
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda *a: 4096 * len(FakeGraph.made))
    return FakeGraph


def test_graph_cache_runs_eager_then_captures_then_replays(fake_graphs):
    """First use of a key: the body runs, no graph. Second: the body runs
    once inside a capture, then the graph replays once for the dispatch.
    Later uses replay only. All graphs share one pool."""
    stats = {}
    cache = dispatch.GraphCache(CUDA, {"decode": 4}, stats)
    runs = []
    body = lambda: runs.append(fake_graphs.capturing)
    cache.run("decode", 16, body)
    assert runs == [False] and not fake_graphs.made
    assert stats["eager_dispatches"] == 1 and stats["graphs_captured"] == 0
    cache.run("decode", 16, body)
    assert runs == [False, True] and len(fake_graphs.made) == 1
    assert fake_graphs.made[0].replays == 1
    cache.run("decode", 16, body)
    cache.run("decode", 16, body)
    assert runs == [False, True] and fake_graphs.made[0].replays == 3
    cache.run("decode", 32, body)            # a new key starts eager again
    cache.run("decode", 32, body)
    assert runs == [False, True, False, True]
    assert [g.pool for g in fake_graphs.made] == ["pool", "pool"]
    assert stats["graphs_captured"] == 2 and stats["graph_replays"] == 4
    assert stats["eager_dispatches"] == 2
    assert stats["graph_pool_bytes"] == 2 * 4096 and stats["capture_s"] >= 0


def test_graph_cache_debug_keeps_the_graph(fake_graphs, monkeypatch):
    """With ``debug`` a capture keeps its graph (``keep_graph=True``, then
    instantiated) for the static checks' dump, and ``graph(kind, key)``
    hands it out; without it the graph is made as serving makes it."""
    class Kept(FakeGraph):
        def __init__(self, keep_graph=False):
            super().__init__()
            self.keep_graph, self.instantiated = keep_graph, False

        def instantiate(self):
            self.instantiated = True
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Kept)
    cache = dispatch.GraphCache(CUDA, {"decode": 2}, {})
    for _ in range(2):
        cache.run("decode", 16, lambda: None)
    plain = cache.graph("decode", 16)
    assert not plain.keep_graph and not plain.instantiated
    assert cache.graph("decode", 32) is None
    cache.debug = True
    for _ in range(2):
        cache.run("decode", 32, lambda: None)
    kept = cache.graph("decode", 32)
    assert kept.keep_graph and kept.instantiated and kept.replays == 1


def test_graph_cache_bounds_its_keys(fake_graphs):
    """Each kind holds at most its bound of distinct keys: the bound + 1-th
    raises, on the card and on the CPU; keys already seen still run."""
    for dev in (CUDA, torch.device("cpu")):
        cache = dispatch.GraphCache(dev, {"decode": 2, "prefill": 3}, {})
        for key in (16, 32, 16, 32):
            cache.run("decode", key, lambda: None)
        with pytest.raises(RuntimeError, match="bound of 2"):
            cache.run("decode", 48, lambda: None)
        for key in ((5, 16), (5, 32), (1, 32)):
            cache.run("prefill", key, lambda: None)
        with pytest.raises(RuntimeError, match="bound of 3"):
            cache.run("prefill", (2, 32), lambda: None)
        cache.run("decode", 16, lambda: None)
        assert cache.keys == {"decode": {16, 32},
                              "prefill": {(5, 16), (5, 32), (1, 32)}}


def test_graph_cache_counts_device_launches(fake_graphs, monkeypatch):
    """A body that launches a kernel 3 times: the eager dispatch counts 3;
    the capture's 3 are taken back and the replay that follows credits 3;
    every later replay 3 more. A kernel the body does not launch gets no
    credit."""
    monkeypatch.setattr(build, "KERNELS", [])
    kern, other = (build.Kernel("k", "k", []), build.Kernel("o", "o", []))

    def body():
        kern.launches += 3

    cache = dispatch.GraphCache(CUDA, {"prefill": 1}, {})
    cache.run("prefill", (16, 64), body)
    assert kern.launches == 3
    cache.run("prefill", (16, 64), body)
    assert kern.launches == 6
    for _ in range(3):
        cache.run("prefill", (16, 64), body)
    assert kern.launches == 15 and other.launches == 0


def test_a_first_use_that_raises_leaves_the_key_unseen(fake_graphs):
    """A body that raises at its key's first use (it may not have made
    what a capture needs, such as a kernel's workspace) leaves the key
    unseen: the next use runs eagerly again, not a capture; the use after
    captures. The bound counts only keys whose first use returned."""
    stats = {}
    cache = dispatch.GraphCache(CUDA, {"decode": 1}, stats)
    runs = []

    def body():
        runs.append(fake_graphs.capturing)
        if len(runs) == 1:
            raise torch.OutOfMemoryError("first use failed")

    with pytest.raises(torch.OutOfMemoryError):
        cache.run("decode", 16, body)
    assert cache.keys == {"decode": set()}
    assert stats["eager_dispatches"] == 0
    cache.run("decode", 16, body)
    assert runs == [False, False] and not fake_graphs.made
    assert cache.keys == {"decode": {16}}
    cache.run("decode", 16, body)
    assert runs == [False, False, True] and stats["graphs_captured"] == 1


def test_a_capture_that_raises_keeps_no_graph(fake_graphs, monkeypatch):
    """A body that raises inside its capture: the capture ends, no graph is
    kept, the launches it counted are taken back, and the next use
    captures again and replays. No cyclic garbage collection runs while a
    capture is open (it could destroy a dead engine's graphs mid-capture),
    and collection is back on after it, whether it raised or not."""
    import gc
    monkeypatch.setattr(build, "KERNELS", [])
    kern = build.Kernel("k", "k", [])
    fail, collecting = [True], []

    def body():
        kern.launches += 2
        if fake_graphs.capturing:
            collecting.append(gc.isenabled())
        if fake_graphs.capturing and fail:
            fail.pop()
            raise RuntimeError("fault inside the capture")

    stats = {}
    cache = dispatch.GraphCache(CUDA, {"decode": 1}, stats)
    cache.run("decode", 16, body)
    assert kern.launches == 2
    with pytest.raises(RuntimeError, match="inside the capture"):
        cache.run("decode", 16, body)
    assert not fake_graphs.capturing and not cache._graphs
    assert kern.launches == 2 and stats["graphs_captured"] == 0
    assert gc.isenabled()
    cache.run("decode", 16, body)
    assert len(cache._graphs) == 1 and fake_graphs.made[-1].replays == 1
    assert kern.launches == 4 and stats["graphs_captured"] == 1
    assert collecting == [False, False] and gc.isenabled()


def test_graph_cache_on_the_cpu_runs_every_dispatch_eagerly():
    stats, runs = {}, []
    cache = dispatch.GraphCache(torch.device("cpu"), {"decode": 1}, stats)
    for _ in range(3):
        cache.run("decode", 16, lambda: runs.append(1))
    assert len(runs) == 3 and stats["eager_dispatches"] == 3
    assert stats["graphs_captured"] == stats["graph_replays"] == 0


def test_inputs_fill_fixed_buffers():
    """One buffer per key, made at the first put and refilled in place;
    a put of another shape into it raises."""
    inputs = dispatch.Inputs(torch.device("cpu"))
    a = inputs.put("decode", np.arange(8, dtype=np.int64).reshape(4, 2))
    b = inputs.put("decode", np.full((4, 2), 7, np.int64))
    assert a is b and a.tolist() == [[7, 7]] * 4
    assert inputs.put(("table", 2), np.ones((3, 2), np.int32)).dtype \
        == torch.int32
    with pytest.raises(ValueError, match="buffer"):
        inputs.put("decode", np.zeros((4, 3), np.int64))


class ReplayBody:
    """A graph that replays by running the body it captured: the closure
    made at the key's second use, so whatever that closure fixed (its
    buffers, sizes, slot) is what every later dispatch of the key gets, as
    with a CUDA graph."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.mark.parametrize("page_size", [None, 8])
def test_engine_with_replayed_captures_equals_serial_decode(
        setup, monkeypatch, page_size):
    """The engine with every key's second-use closure replayed in place of
    its later dispatches: token-identical to serial decode, with captures
    and replays in both kinds (a body that took a per-dispatch value at
    capture would replay it stale)."""
    cfg, models = setup
    params, qkv = models["hqp"]
    monkeypatch.setattr(dispatch.GraphCache, "_capture",
                        lambda self, body: (ReplayBody(body), []))
    eng = Engine(params, cfg, n_slots=3, max_seq=64,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 quantized_kv=qkv, device="cpu", page_size=page_size)
    eng.graphs.device = CUDA
    prompts = _prompts(cfg, [13, 7, 30, 21, 9, 12], seed=2)
    res = eng.run([Request(prompt=p, max_new_tokens=12) for p in prompts],
                  arrival_ticks=[0, 2, 6, 9, 10, 11])
    for i, p in enumerate(prompts):
        assert res[i].tokens == serial_decode(
            params, cfg, p, 12, max_seq=64, quantized_kv=qkv,
            device="cpu"), i
    captured = [kind for kind, _ in eng.graphs._graphs]
    assert eng.stats["graph_replays"] > len(captured)
    assert {"decode", "prefill"} <= set(captured)


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("page_size", [None, 8])
def test_keys_within_the_reference_lowering_bounds(page_size):
    """The engine's key bounds are the JAX engine's declared
    ``max_lowerings`` (decode: one per window bucket; prefill: one per
    (window, chunk width), times the slots in the contiguous layout, where
    a graph holds the slot's cache view). On the same requests the paged
    engine uses exactly as many decode and prefill keys as the reference
    compiles executables, and the contiguous one as many decode keys."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    sched = dict(prefill_chunk=4, decode_steps=4)
    n_slots, max_seq = 2, 48
    jeng = JEngine(jp, jcfg, ctx=default_ctx(), n_slots=n_slots,
                   max_seq=max_seq, sched=JSchedulerConfig(**sched),
                   page_size=page_size)
    eng = Engine(tp, cfg, n_slots=n_slots, max_seq=max_seq,
                 sched=SchedulerConfig(**sched), device="cpu",
                 page_size=page_size)
    prompts = _prompts(cfg, [9, 14, 5], seed=3)
    jeng.run([JRequest(prompt=p, max_new_tokens=8) for p in prompts])
    eng.run([Request(prompt=p, max_new_tokens=8) for p in prompts])
    per_slot = 1 if page_size else n_slots
    assert eng.graphs.bounds == {
        "decode": spec_of(jeng._decode_fn).max_lowerings,
        "prefill": spec_of(jeng._prefill_fn).max_lowerings * per_slot}
    assert len(eng.graphs.keys["decode"]) == jeng._decode_fn._cache_size()
    n_prefill = len(eng.graphs.keys["prefill"])
    if page_size:
        assert n_prefill == jeng._prefill_fn._cache_size()
    else:
        assert len({k[:2] for k in eng.graphs.keys["prefill"]}) \
            == jeng._prefill_fn._cache_size() <= n_prefill


# ------------------------------------------------ the padded logits
def test_padded_logits_are_exactly_minus_1e30(setup):
    """``logits_fn`` masks the padded vocab with a Python scalar (no
    host-to-device copy under capture): those logits hold the bits of f32
    -1e30 (tolerance 0), the real ones the unembed's."""
    cfg, _ = setup
    cfg = dataclasses.replace(cfg, vocab_size=200)
    params = lm.init_params(cfg, seed=1, device="cpu")
    hidden = torch.randn(2, 1, cfg.d_model).to(torch.bfloat16)
    logits = lm.logits_fn(params, cfg, hidden)
    assert logits.shape[-1] == lm.padded_vocab(cfg) == 256
    pad = logits[..., cfg.vocab_size:].contiguous().view(torch.int32)
    want = torch.tensor(-1e30, dtype=torch.float32).view(torch.int32)
    assert bool((pad == want).all())
    real = lm.unembed_params(params, cfg)
    assert torch.equal(logits[..., :cfg.vocab_size],
                       L.unembed(real, hidden)[..., :cfg.vocab_size])
