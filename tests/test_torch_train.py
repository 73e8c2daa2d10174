"""The port's training path on the CPU, held against the JAX package: the
synthetic token corpus, the INT8 moment codec, one and three AdamW steps,
and the train step on the qwen3-0.6b smoke config, from the same numpy
inputs.

Tolerances and exact equalities:
  * ``SyntheticTokens``: the same sequences, dtype and ceiling, bit for bit;
  * the INT8 codec: codes and scales equal to the reference's called
    eagerly (where ``/ 127`` is a true division; ROADMAP C1);
  * AdamW: the f32 moments within 1e-6 of their leaf's largest magnitude
    (the global norm behind the clip factor is summed in another order, an
    ulp or two apart, and m = b1·m + (1 - b1)·g can cancel, so an element
    near zero has no relative bound); the INT8 moments' codes exact, their
    scales within 1e-6 relative; the bf16 params
    within one bf16 ulp (the bias corrections' ``b ** step`` are two
    frameworks' f32 ``pow``);
  * the train step: the loss within 1e-3 relative (the forward's bf16
    roundings differ at the ulp level, ``test_torch_hqp.py``); the f32
    moments after one step, 0.1 x the clipped bf16 gradient, within 2 % of
    their leaf's largest magnitude (the gradients' tolerance in
    ``test_torch_hqp.py``); each param within 2·lr + one bf16 ulp: Adam's
    first step moves a weight by lr·g/(|g| + eps) ~ ±lr, so a gradient whose
    sign flips between the frameworks at the ulp level puts it 2·lr apart,
    and at most 1 % of the weights may be more than one ulp apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params, stack_blocks  # noqa: E402

ARCH = "qwen3-0.6b"
MOMENT_RTOL = 1e-6
GRAD_FRAC = 2e-2
LOSS_RTOL = 1e-3


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits; f32's spacing x 2^16)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


def _np(x) -> np.ndarray:
    """f32 numpy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------ corpus
@pytest.mark.parametrize("vocab,seq,n", [(256, 33, 64), (1000, 17, 40)])
@pytest.mark.parametrize("seed", [0, 9])
def test_synthetic_tokens_match_reference(seed, vocab, seq, n):
    got = SyntheticTokens(vocab, seq, n, seed=seed, determinism=0.9)
    want = JSyntheticTokens(vocab, seq, n, seed=seed, determinism=0.9)
    assert got.seqs.dtype == want.seqs.dtype
    np.testing.assert_array_equal(got.seqs, want.seqs)
    assert got.best_acc == want.best_acc
    for a, b in zip(got.batches(8, seed=3, epochs=2),
                    want.batches(8, seed=3, epochs=2)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_chain_seed_samples_the_same_chain():
    """``chain_seed=0`` draws seed 0's transition table: every transition
    of the seed-9 corpus is one of the seed-0 chain's, while the
    reference's seed-9 corpus is another chain."""
    vocab = 64
    train = SyntheticTokens(vocab, 20, 100, seed=0)
    edges = lambda seqs: {(a, b) for row in seqs
                          for a, b in zip(row[:-1], row[1:])}
    chain = {(a, b) for a in range(vocab) for b in train.succ[a]}
    assert edges(train.seqs) <= chain
    same = SyntheticTokens(vocab, 20, 100, seed=9, chain_seed=0)
    other = SyntheticTokens(vocab, 20, 100, seed=9)
    np.testing.assert_array_equal(same.succ, train.succ)
    assert edges(same.seqs) <= chain
    assert not edges(other.seqs) <= chain


# ------------------------------------------------------------------ codec
def _codec_cases():
    rng = np.random.RandomState(5)
    normal = (rng.randn(6, 40) * np.logspace(-6, 2, 6)[:, None]
              ).astype(np.float32)
    zero_rows = normal.copy()
    zero_rows[[1, 4]] = 0.0
    # rows whose codes sit exactly halfway: absmax 127 makes the scale 1
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -3.5],
                     [-127.0, 4.5, -4.5, 5.5, 0.0, 63.5, 64.5, -1.5]],
                    np.float32)
    v = (rng.rand(3, 5, 16) * 1e-3).astype(np.float32)
    v[0, 0, :4] = -1e-9          # negatives the sqrt map clamps to 0
    return {"normal": (normal, False), "zero_rows": (zero_rows, False),
            "ties": (ties, False), "vector": (normal[2], False),
            "sqrt_map": (v, True), "sqrt_zero_rows": (zero_rows ** 2, True)}


CODEC = _codec_cases()


@pytest.mark.parametrize("case", sorted(CODEC))
def test_int8_codec_matches_reference(case):
    x, sqrt_map = CODEC[case]
    q, s = opt._encode(torch.from_numpy(x), sqrt_map=sqrt_map)
    jq, js = jopt._encode(jnp.asarray(x), sqrt_map=sqrt_map)
    assert q.dtype == torch.int8 and tuple(s.shape) == js.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = opt._decode(q, s, x.shape, sqrt_map=sqrt_map)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jopt._decode(jq, js, x.shape,
                                              sqrt_map=sqrt_map)))
    if case == "ties":           # round half to even
        assert q[0, 1:6].tolist() == [0, 2, 2, -2, 0]


# ------------------------------------------------------------------ AdamW
def _toy(seed: int, grad_scale: float):
    """bf16 params (a matrix, a vector, a per-layer list) and bf16
    gradients from numpy, for both frameworks."""
    rng = np.random.RandomState(seed)
    shapes = {"w": (16, 12), "b": (12,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    layer = rng.randn(2, 8, 4).astype(np.float32)
    grads = [{k: (rng.randn(*s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, layer, grads


def _trees(params, layer):
    t = {**{k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in params.items()},
         "blocks": [{"w": torch.from_numpy(layer[i]).to(torch.bfloat16)}
                    for i in range(2)]}
    j = {**{k: jnp.asarray(v).astype(jnp.bfloat16)
            for k, v in params.items()},
         "blocks": ({"w": jnp.asarray(layer).astype(jnp.bfloat16)},)}
    return t, j


def _flat_port(state) -> dict:
    """A port tree's leaves in the JAX layout, keyed by path, f32 numpy."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node
    walk(stack_blocks(state), ())
    return out


def _flat_ref(state) -> dict:
    from repro.sharding.rules import path_str
    return {path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.mark.parametrize("clipped", [True, False])
@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_adamw_update_matches_reference(state_dtype, n_steps, clipped):
    scale = 1.0 if clipped else 0.01
    params, layer, grads = _toy(seed=11, grad_scale=scale)
    cfg = opt.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    jcfg = jopt.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    tp, jp = _trees(params, layer)
    ts, js = opt.adamw_init(tp, cfg), jopt.adamw_init(jp, jcfg)
    for i in range(n_steps):
        g_t, g_j = _trees(grads[i], layer * (0.3 * (i + 1) * scale))
        gnorm = float(opt._global_norm(g_t))
        assert (gnorm > cfg.grad_clip) == clipped
        tp, ts = opt.adamw_update(tp, g_t, ts, cfg)
        jp, js = jopt.adamw_update(jp, g_j, js, jcfg)      # eagerly
    assert int(ts["step"]) == int(js["step"]) == n_steps
    got, want = _flat_port(tp), _flat_ref(jp)
    assert sorted(got) == sorted(want)
    for k in got:
        a, b = _np(got[k]), _np(want[k])
        assert np.all(np.abs(a - b) <= _bf16_ulp(b)), k
    got = _flat_port({"m": ts["m"], "v": ts["v"]})
    want = _flat_ref({"m": js["m"], "v": js["v"]})
    assert sorted(got) == sorted(want)
    for k in got:
        if k.endswith("/q"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        elif k.endswith("/s"):
            np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                       rtol=MOMENT_RTOL, atol=0, err_msg=k)
        else:
            a, b = _np(got[k]), _np(want[k])
            assert np.abs(a - b).max() <= MOMENT_RTOL * np.abs(b).max(), k


# ------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.RandomState(4).randint(0, jcfg.vocab_size, (4, 17))
    return dict(jcfg=jcfg, cfg=configs.get_smoke_config(ARCH), jp=jp,
                tp=from_jax_params(jax.tree.map(np.asarray, jp),
                                   device="cpu"),
                tokens=tokens)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(smoke, microbatches):
    lr = 1e-3
    ocfg, jocfg = opt.AdamWConfig(lr=lr), jopt.AdamWConfig(lr=lr)
    step = make_train_step(smoke["cfg"], ocfg, microbatches)
    jstep = jax.jit(jmake_train_step(smoke["jcfg"], default_ctx(), jocfg,
                                     microbatches))
    tp, ts, m = step(smoke["tp"], opt.adamw_init(smoke["tp"], ocfg),
                     {"tokens": torch.as_tensor(smoke["tokens"])})
    jp, js, jm = jstep(smoke["jp"], jopt.adamw_init(smoke["jp"], jocfg),
                       {"tokens": jnp.asarray(smoke["tokens"], jnp.int32)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    got, want = _flat_port(ts["m"]), _flat_ref(js["m"])
    assert sorted(got) == sorted(want)
    for k in got:
        a, b = _np(got[k]), _np(want[k])
        assert np.abs(a - b).max() <= GRAD_FRAC * np.abs(b).max(), k
    got, want = _flat_port(tp), _flat_ref(jp)
    assert sorted(got) == sorted(want)
    far = n = 0
    for k in got:
        a, b = _np(got[k]), _np(want[k])
        assert np.all(np.abs(a - b) <= 2 * lr + _bf16_ulp(b)), k
        far += int(np.sum(np.abs(a - b) > _bf16_ulp(b)))
        n += a.size
    assert far <= 0.01 * n, (far, n)
    # the input params are not modified
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(smoke["tp"]),
        tree.leaves(from_jax_params(jax.tree.map(np.asarray, smoke["jp"]),
                                    device="cpu"))))


def test_microbatches_average_the_batch(smoke):
    """Two microbatches of two rows: the loss is the mean of the halves'
    losses, equal within f32 rounding to the whole batch's mean."""
    ocfg = opt.AdamWConfig(lr=1e-3)
    batch = {"tokens": torch.as_tensor(smoke["tokens"])}
    losses = [float(make_train_step(smoke["cfg"], ocfg, n)(
        smoke["tp"], opt.adamw_init(smoke["tp"], ocfg), batch)[2]["loss"])
        for n in (1, 2)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(smoke["cfg"], ocfg, 3)(
            smoke["tp"], opt.adamw_init(smoke["tp"], ocfg), batch)
