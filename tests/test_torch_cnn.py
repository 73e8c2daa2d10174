"""The port's CNN track on the CPU, held against the JAX package at width
0.25 with the same weights (the port's seed-0 draw in both) and the same
numpy images: the two models' forwards (SAME padding at stride 2
included), the prune families, ranking, masks and per-family compaction,
Algorithm 1 with ``protect_frac``, and the weights carried across
(``test_torch_cnn_quant.py`` holds calibration and the fake-quant track,
``test_torch_cnn_experiment.py`` training and the Fisher,
``test_torch_cnn_compress.py`` ``compress``,
``test_torch_cnn_table.py`` the cost count and the table).

Tolerances and exact equalities:
  * forward: f32 in both, the convs summed in other orders over ~20
    layers: logits and new BN statistics within rtol 1e-4, atol 1e-4 (the
    largest difference seen is ~7e-6 of |logits| up to ~11);
  * given one Fisher diagonal (the port's, carried into the JAX package;
    ``test_torch_cnn_experiment.py`` holds it against the reference's),
    everything integer is exact:
    the ranking, masks, compacted tensors and Algorithm 1's decisions; the
    per-unit S within 1e-6 relative (the port sums in f64, the reference
    in f32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_cnn_common import (ARCHS, WIDTH, assert_trees, flat,  # noqa: E402
                               nets, one_thread)  # noqa: F401
from repro.configs import get_cnn_config as jget_cnn_config  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.configs import get_cnn_config  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core import pruning as pr  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.data.synthetic import SyntheticImages  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.weights import from_jax_cnn_variables  # noqa: E402

FWD = dict(rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ models
def test_cnn_config_equals_reference():
    for arch in ARCHS:
        assert (dataclasses.asdict(get_cnn_config(arch))
                == dataclasses.asdict(jget_cnn_config(arch)))


def test_synthetic_images_bit_equal():
    from repro.data.synthetic import SyntheticImages as JImages
    t, j = SyntheticImages(40, seed=3), JImages(40, seed=3)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    for bt, bj in zip(t.batches(16, seed=1, epochs=2),
                      j.batches(16, seed=1, epochs=2)):
        np.testing.assert_array_equal(bt["image"], bj["image"])
        np.testing.assert_array_equal(bt["label"], bj["label"])
    assert len(list(t.batches(16))) == 2          # the tail of 8 dropped


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_equals_reference(nets, arch, train):
    """Logits and new stats; ResNet has stride-2 convs at k 3 (and 1x1
    downsamples), MobileNet at k 3 (b1) and k 5 (b3, b8), so symmetric
    padding would shift their outputs."""
    n = nets[arch]
    jl, jst = jax.jit(lambda v, x: jcnn.cnn_apply(n["jcfg"], v, x, train))(
        n["jv"], jnp.asarray(n["x"]))
    with torch.no_grad():
        tl, tst = cnn.cnn_apply(n["cfg"], n["tv"], torch.from_numpy(n["x"]),
                                train)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    assert_trees(tst, jst, **FWD)


@pytest.mark.parametrize("k,stride,size", [(3, 2, 32), (5, 2, 32), (5, 2, 7),
                                           (3, 1, 16), (1, 2, 16)])
def test_same_padding_is_the_reference(k, stride, size):
    """The port's conv equals ``lax.conv_general_dilated(..., "SAME")``; at
    stride 2 on an even input the padding is (0, 1) at k 3 and (1, 2) at
    k 5, where ``F.conv2d``'s symmetric padding gives other values."""
    rng = np.random.RandomState(k * 100 + size)
    x = rng.randn(2, size, size, 6).astype(np.float32)
    w = rng.randn(k, k, 6, 4).astype(np.float32)
    want = np.asarray(jcnn.conv(jnp.asarray(x), jnp.asarray(w), stride))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = cnn.conv(xt, torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if stride == 2 and size % 2 == 0 and k > 1:
        sym = torch.nn.functional.conv2d(
            xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride,
            padding=k // 2).permute(0, 2, 3, 1)
        assert not np.allclose(sym.numpy(), want, rtol=1e-3, atol=1e-3)


def test_depthwise_and_activations():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 5).astype(np.float32) * 4
    w = rng.randn(5, 5, 1, 5).astype(np.float32)
    want = np.asarray(jcnn.conv(jnp.asarray(x), jnp.asarray(w), 2, groups=5))
    got = cnn.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w), 2, groups=5).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for tf, jf in ((cnn.hswish, jcnn.hswish), (cnn.hsigmoid, jcnn.hsigmoid)):
        np.testing.assert_array_equal(tf(torch.from_numpy(x)).numpy(),
                                      np.asarray(jf(jnp.asarray(x))))


def test_bn_uses_the_biased_variance():
    """Training BN normalizes by, and updates the running variance with,
    the biased batch variance; ``F.batch_norm`` would update it with the
    unbiased one."""
    x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    p, st = cnn.bn_init(3)
    _, new = cnn.bn_apply(p, st, x, train=True)
    var = x.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(new["var"], 0.9 * torch.ones(3) + 0.1 * var)
    jx = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    jp, jst = jcnn.bn_init(3)
    _, jnew = jcnn.bn_apply(jp, jst, jx, train=True)
    np.testing.assert_allclose(new["var"].numpy(), np.asarray(jnew["var"]),
                               rtol=1e-6)


def test_mobilenet_residual_and_se_width(nets):
    """The SE width is max(8, exp // 4); the residual is decided by the
    shapes after compaction (the expand family never changes the block's
    output width)."""
    tv = nets["mobilenetv3s"]["tv"]["params"]
    for i, (_, exp, _, se, _, _) in enumerate(cnn.MBV3S_BLOCKS):
        if se:
            want = max(8, int(exp * WIDTH) // 4)
            assert tv[f"b{i}"]["se_down"]["w"].shape[3] == want


# ------------------------------------------------------------------ pruning
@pytest.mark.parametrize("arch", ARCHS)
def test_prune_groups_equal_reference(nets, arch):
    n = nets[arch]
    js = jsens.cnn_prune_groups(n["jcfg"], n["jv"])
    ts = sens.cnn_prune_groups(n["cfg"], n["tv"])
    assert [dataclasses.astuple(s) for s in ts] == \
        [dataclasses.astuple(s) for s in js]


@pytest.mark.parametrize("arch,protect", [("resnet18", 0.0),
                                           ("mobilenetv3s", 0.0),
                                           ("resnet18", 0.25)])
def test_rank_mask_compact_exact(nets, arch, protect):
    """With the reference's Fisher: the same ranking, masks and compacted
    tensors, exactly; masked == compacted logits."""
    n = nets[arch]
    js = jsens.cnn_prune_groups(n["jcfg"], n["jv"])
    ts = sens.cnn_prune_groups(n["cfg"], n["tv"])
    jr = jpr.rank_units(js, n["jsq"], protect)
    tr = pr.rank_units(ts, n["tsq"], protect)
    np.testing.assert_array_equal(tr.spec_idx, jr.spec_idx)
    np.testing.assert_array_equal(tr.unit_idx, jr.unit_idx)
    np.testing.assert_allclose(tr.s_values, jr.s_values, rtol=1e-6)
    n_drop = tr.total // 3
    tm = pr.apply_prune_masks(n["tv"], tr, n_drop)
    # the reference's masks and compaction, traced once (its ops one by one
    # would compile one by one)
    jm = jax.jit(lambda v: jpr.apply_prune_masks(v, jr, n_drop))(n["jv"])
    assert_trees(tm, jm, exact=True)
    tc = pr.compact_params(tm, tr, n_drop)
    jc = jax.jit(lambda v: jpr.compact_params(v, jr, n_drop))(jm)
    assert_trees(tc, jc, exact=True)
    assert pr.param_bytes(tc) == jpr.param_bytes(jc)
    x = torch.from_numpy(n["x"])
    with torch.no_grad():
        lm = cnn.cnn_apply(n["cfg"], tm, x)[0]
        lc = cnn.cnn_apply(n["cfg"], tc, x)[0]
    torch.testing.assert_close(lc, lm, rtol=1e-4, atol=1e-4)


def test_resnet_families_of_one_size_compact_apart(nets):
    """``s0b0/conv1`` and ``s0b1/conv1`` have one size; each keeps its own
    undropped channels (the LM's shape-uniform rule would pad both to one
    width), as the reference's per-family compaction does."""
    n = nets["resnet18"]
    ts = sens.cnn_prune_groups(n["cfg"], n["tv"])
    js = jsens.cnn_prune_groups(n["jcfg"], n["jv"])
    i0, i1 = ([s.name for s in ts].index(f) for f in ("s0b0/conv1",
                                                       "s0b1/conv1"))
    assert ts[i0].size == ts[i1].size == 16
    spec_idx = np.array([i0] * 3 + [i1] * 7)
    unit_idx = np.array([1, 4, 9, 0, 2, 3, 5, 6, 7, 8])
    s_vals = np.arange(10, dtype=np.float32)
    tr = pr.RankedUnits(ts, spec_idx, unit_idx, s_vals)
    jr = jpr.RankedUnits(js, spec_idx, unit_idx, s_vals)
    tc = pr.compact_params(pr.apply_prune_masks(n["tv"], tr, 10), tr, 10)
    assert tc["params"]["s0b0"]["conv1"].shape[3] == 13
    assert tc["params"]["s0b1"]["conv1"].shape[3] == 9
    assert tc["params"]["s0b1"]["conv2"].shape[2] == 9
    assert tc["stats"]["s0b1"]["bn1"]["var"].shape == (9,)
    jc = jpr.compact_params(jpr.apply_prune_masks(n["jv"], jr, 10), jr, 10)
    assert_trees(tc, jc, exact=True)



def test_algorithm1_protect_frac_equals_reference(nets):
    """``HQPConfig.protect_frac`` reaches the ranking inside Algorithm 1:
    with a deterministic eval_fn (the fraction of conv channels left) both
    packages take the same steps to the same n_drop, and no family loses
    a unit of its top quarter by S."""
    n = nets["resnet18"]
    ts = sens.cnn_prune_groups(n["cfg"], n["tv"])
    js = jsens.cnn_prune_groups(n["jcfg"], n["jv"])

    def eval_fn(variables):
        ws = [v for v in flat(variables["params"]).values() if v.ndim == 4]
        return sum(np.count_nonzero(w) for w in ws) / sum(w.size for w in ws)

    kw = dict(delta_ax=0.3, step_frac=0.05, max_steps=60, protect_frac=0.25)
    quiet = lambda s: None  # noqa: E731
    tres = pipe.conditional_prune(n["tv"], ts, n["tsq"], eval_fn,
                                  pipe.HQPConfig(**kw), a_baseline=1.0,
                                  log=quiet)
    jres = jpipe.conditional_prune(n["jv"], js, n["jsq"], eval_fn,
                                   jpipe.HQPConfig(**kw), a_baseline=1.0,
                                   log=quiet)
    assert tres.n_drop == jres.n_drop > 0
    assert tres.ranked.total == jres.ranked.total < sum(s.size for s in ts)
    assert ([(h.n_drop, h.accuracy, h.accepted) for h in tres.history]
            == [(h.n_drop, h.accuracy, h.accepted) for h in jres.history])
    for spec, drops in zip(ts, tres.ranked.drops_per_spec(tres.n_drop)):
        s = sens.group_sensitivity(n["tsq"], spec).numpy()
        top = np.argsort(s)[spec.size - int(np.ceil(0.25 * spec.size)):]
        assert not set(drops) & set(top), spec.name


def test_from_jax_cnn_variables(nets):
    """The JAX package's numpy variables cross with their layout."""
    n = nets["mobilenetv3s"]
    got = from_jax_cnn_variables(jax.tree.map(np.asarray, n["jv"]),
                                 device="cpu")
    assert_trees(got, n["tv"], exact=True)
    assert got["params"]["b3"]["dw"].shape == (5, 5, 1, 24)
