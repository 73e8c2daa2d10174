"""Seeded sampling in the port (``repro_torch.serving.prng`` and
``sampling``) against ``jax.random`` and the JAX package's sampler on the
same inputs, and the port's sampled engine against its sampled serial
decode, bit for bit."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampling as jsmp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import quantize_lm_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request, SchedulerConfig  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.serving import prng  # noqa: E402
from repro_torch.serving import sampling as smp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-0.6b"
TINY = float(np.finfo(np.float32).tiny)
# 2^40 + 5: JAX's default 32-bit mode keeps the low word of a 64-bit seed
SEEDS = (0, 7, 1234, 2 ** 31 + 3, 2 ** 40 + 5)
POSITIONS = np.array([0, 1, 97, 255, 70_000], np.int64)
# |torch.log - XLA's log| is an ulp or two; gumbel = -log(-log(u))
GUMBEL_TOL = dict(rtol=1e-6, atol=1e-6)
# warped logits and probabilities: exp and the normalising sum round
# differently in the two libraries
PROBS_TOL = dict(rtol=1e-6, atol=1e-12)
# a row whose top two perturbed scores lie closer than this may break the
# other way in the other library
NEAR_TIE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and under the suite's parallel workers torch's default pool (a thread
    a core in every worker) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_equal_jax_random(seed):
    """PRNGKey, the fold_in of every lane and position, random bits, and
    uniforms of the folded keys equal jax.random's exactly; gumbel noise
    agrees to an ulp of log."""
    base = smp.base_key(smp.SamplingConfig(seed=seed), "cpu")
    jbase = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(base.numpy(), _key_data(jbase))
    for lane in (smp.LANE_TOKEN, smp.LANE_ACCEPT, smp.LANE_RESIDUAL):
        keys = smp.token_key(base, torch.from_numpy(POSITIONS), lane)
        jkeys = [jsmp.token_key(jbase, int(p), lane) for p in POSITIONS]
        np.testing.assert_array_equal(
            keys.numpy(), np.stack([_key_data(k) for k in jkeys]))
        for key, jkey in zip(keys, jkeys):
            np.testing.assert_array_equal(
                prng.random_bits(key, (3, 257)).numpy(),
                np.asarray(jax.random.bits(jkey, (3, 257))).astype(np.int64))
            np.testing.assert_array_equal(
                prng.uniform(key, (1000,), TINY, 1.0).numpy(),
                np.asarray(jax.random.uniform(jkey, (1000,), minval=TINY,
                                              maxval=1.0)))
            np.testing.assert_array_equal(
                prng.uniform(key).numpy(),
                np.asarray(jax.random.uniform(jkey)))
            np.testing.assert_allclose(
                prng.gumbel(key, (1000,)).numpy(),
                np.asarray(jax.random.gumbel(jkey, (1000,))), **GUMBEL_TOL)


def test_random_bits_over_a_full_width_vocab():
    """One key, 152,064 counters (the padded qwen3-0.6b vocab): every word
    equal."""
    key = smp.token_key(smp.base_key(smp.SamplingConfig(seed=1234)), 97)
    jkey = jsmp.token_key(jax.random.PRNGKey(1234), 97)
    np.testing.assert_array_equal(
        prng.random_bits(key, (152_064,)).numpy(),
        np.asarray(jax.random.bits(jkey, (152_064,))).astype(np.int64))


def _tied_logits(rng, b, v, k):
    """f32 logits whose k-th largest value repeats, so the top-k boundary
    holds ties, in every row."""
    lg = rng.standard_normal((b, v)).astype(np.float32) * 3
    for row in lg:
        order = np.argsort(-row)
        row[order[k:k + 3]] = row[order[k - 1]]
    return lg


CONFIGS = [smp.SamplingConfig(0.8, 50, 7), smp.SamplingConfig(1.0, 0, 1),
           smp.SamplingConfig(0.5, 5, 3), smp.SamplingConfig(1.3, 255, 9),
           smp.SamplingConfig(0.0, 8, 0)]


@pytest.mark.parametrize("scfg", CONFIGS, ids=str)
def test_warp_and_probs_equal_reference(scfg):
    """Top-k keeps every logit >= the k-th largest (the boundary's ties
    too), then the temperature; both within 1e-6 relative of the JAX
    package's on the same f32 logits."""
    rng = np.random.RandomState(scfg.seed)
    k = scfg.top_k or 50
    lg = _tied_logits(rng, 6, 256, k)
    jcfg = jsmp.SamplingConfig(scfg.temperature, scfg.top_k, scfg.seed)
    warped = smp.warp_logits(torch.from_numpy(lg), scfg).numpy()
    want = np.asarray(jsmp.warp_logits(jnp.asarray(lg), jcfg))
    np.testing.assert_array_equal(np.isinf(warped), np.isinf(want))
    if 0 < scfg.top_k < 256:
        assert (np.isfinite(want).sum(-1) > scfg.top_k).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(warped[fin], want[fin], **PROBS_TOL)
    np.testing.assert_allclose(
        smp.probs(torch.from_numpy(lg), scfg).numpy(),
        np.asarray(jsmp.probs(jnp.asarray(lg), jcfg)), **PROBS_TOL)


@pytest.mark.parametrize("scfg,b,v", [(CONFIGS[0], 256, 256),
                                      (CONFIGS[1], 256, 256),
                                      (CONFIGS[2], 128, 256),
                                      (CONFIGS[0], 4, 152_064)],
                         ids=["t0.8-k50", "t1.0", "t0.5-k5", "full-vocab"])
def test_sample_batch_equals_reference(scfg, b, v):
    """Per-row draws keyed by position equal the JAX package's
    ``sample_batch`` on the same logits, except in rows where the
    reference's top two perturbed scores lie within NEAR_TIE (counted in
    the assertion message; they break on an ulp of log)."""
    rng = np.random.RandomState(b + v)
    lg = rng.standard_normal((b, v)).astype(np.float32) * 2
    pos = rng.randint(0, 4096, b).astype(np.int64)
    jcfg = jsmp.SamplingConfig(scfg.temperature, scfg.top_k, scfg.seed)
    jbase = jsmp.base_key(jcfg)
    want = np.asarray(jsmp.sample_batch(jnp.asarray(lg), jcfg, jbase,
                                        jnp.asarray(pos, jnp.int32)))
    got = smp.sample_batch(torch.from_numpy(lg), scfg,
                           smp.base_key(scfg), torch.from_numpy(pos)).numpy()
    keys = jax.vmap(lambda p: jsmp.token_key(jbase, p))(
        jnp.asarray(pos, jnp.int32))
    scores = np.asarray(jax.vmap(
        lambda k, l: jax.random.gumbel(k, (v,)) + jsmp.warp_logits(l, jcfg))(
            keys, jnp.asarray(lg)))
    top2 = np.sort(scores, axis=-1)[:, -2:]
    near = top2[:, 1] - top2[:, 0] <= NEAR_TIE
    differ = got != want
    assert not (differ & ~near).any(), (
        f"rows {np.nonzero(differ & ~near)[0]} differ with no near tie; "
        f"{near.sum()} near-tie rows of {b}")
    # the comparison decides almost every row (0 near ties on these inputs)
    assert near.sum() <= b // 16, f"{near.sum()} near-tie rows of {b}"


def test_greedy_takes_no_keys():
    """Greedy is the key-free argmax, first index on ties."""
    lg = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]])
    assert smp.GREEDY.is_greedy
    assert smp.sample_batch(lg, smp.GREEDY, None, None).tolist() == [1, 0]
    assert smp.greedy(lg).dtype == torch.int32
    assert smp.greedy(lg).tolist() == [1, 0]


def test_sampling_modules_use_no_global_or_stateful_rng():
    """No ``torch.Generator``, ``torch.multinomial``, seeding or global
    draw in the sampling path: a graph replay would advance their state."""
    on_torch = {"Generator", "multinomial", "manual_seed", "seed", "rand",
                "randn", "randint", "randperm", "bernoulli", "normal",
                "poisson", "rand_like", "randn_like", "randint_like",
                "get_rng_state", "set_rng_state", "random"}
    methods = {"uniform_", "exponential_", "normal_", "bernoulli_",
               "random_", "geometric_", "cauchy_", "log_normal_",
               "multinomial"}
    for name in ("prng", "sampling", "speculative"):
        path = ROOT / "src" / "repro_torch" / "serving" / f"{name}.py"
        attrs = [node for node in ast.walk(ast.parse(path.read_text()))
                 if isinstance(node, ast.Attribute)]
        bad = {a.attr for a in attrs if a.attr in methods or (
            a.attr in on_torch and isinstance(a.value, ast.Name)
            and a.value.id == "torch")}
        assert not bad, (name, bad)


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config(ARCH)
    params = quantize_lm_params(lm.init_params(cfg, seed=0, device="cpu"))
    return cfg, params


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


@pytest.mark.parametrize("page_size", [None, 16])
def test_sampled_engine_equals_sampled_serial_decode(setup, page_size):
    """Temperature 0.8, top-k 50, seed 7, staggered arrivals, a chunk (5)
    that divides no prompt, 4 steps a dispatch: every request's tokens
    equal sampled serial decode's, bit for bit, and differ from greedy."""
    cfg, params = setup
    scfg = smp.SamplingConfig(temperature=0.8, top_k=50, seed=7)
    prompts = _prompts(cfg, [13, 7, 30, 21], seed=2)
    eng = Engine(params, cfg, n_slots=3, max_seq=64,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 quantized_kv=True, device="cpu", sampling=scfg,
                 page_size=page_size)
    res = eng.run([Request(prompt=p, max_new_tokens=12) for p in prompts],
                  arrival_ticks=[0, 2, 6, 9])
    greedy_differs = 0
    for i, p in enumerate(prompts):
        want = serial_decode(params, cfg, p, 12, max_seq=64,
                             quantized_kv=True, device="cpu", sampling=scfg)
        assert res[i].tokens == want, i
        greedy_differs += want != serial_decode(
            params, cfg, p, 12, max_seq=64, quantized_kv=True, device="cpu")
    assert greedy_differs == len(prompts)
    assert eng.stats["accepted_tokens"] == 4 * 11
    assert eng.stats["drafted_tokens"] >= eng.stats["accepted_tokens"]


def test_serve_cli_sampled_runs_verify_on_cpu(capsys):
    """A sampled engine run verifies against sampled serial decode; the
    lockstep loop samples with the same key rule."""
    serve.main(["--smoke", "--device", "cpu", "--engine", "--temperature",
                "0.8", "--top-k", "50", "--seed", "7", "--tokens", "6",
                "--prompt-len", "9", "--max-seq", "32"])
    assert "token-identical to serial decode" in capsys.readouterr().out
    serve.main(["--smoke", "--device", "cpu", "--temperature", "0.8",
                "--seed", "7", "--tokens", "4", "--prompt-len", "9",
                "--max-seq", "32"])
    assert "sample continuation" in capsys.readouterr().out
