"""The port's calibration and fake-quant track on the CPU, held against
the JAX package at width 0.25 with the same weights and images.

Tolerances and exact equalities:
  * calibration: the same histogram gives the same threshold, bit for bit;
    the scales over the model (whose activations differ at the f32 ulp
    level, which may move a percentile by one of 2,048 bins) within 2e-3;
  * fake quant: ROADMAP C1, the reference quantizes under ``jit``, where
    XLA divides by 127 through a multiply by fl(1/127): a value within one
    quantization step of the port's; the simulated bytes exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_cnn_common import flat, nets, one_thread  # noqa: E402,F401
from repro.compress import quantize as jcq  # noqa: E402
from repro.core import calibration as jcalib  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.compress import quantize as cq  # noqa: E402
from repro_torch.core import calibration as calib  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


# ------------------------------------------------------------------ calibration
def _tap_stats(n, method, reference=True):
    """The port's ActQ (and the reference's) after the amax and hist passes
    over the images."""
    tq = calib.ActQ(mode="amax", method=method)
    jq = jcalib.ActQ(mode="amax", method=method) if reference else None
    x = torch.from_numpy(n["x"])
    for mode in ("amax", "hist"):
        tq.mode = mode
        with torch.no_grad():
            cnn.cnn_apply(n["cfg"], n["tv"], x, actq=tq)
        if reference:
            jq.mode = mode
            jcnn.cnn_apply(n["jcfg"], n["jv"], jnp.asarray(n["x"]), actq=jq)
    return tq, jq


def test_thresholds_bit_equal_on_equal_histograms(nets):
    """kl / percentile / absmax on the port's histogram of a tap (and on
    one with an outlier): the same floats as the
    reference's on the same arrays."""
    tq, _ = _tap_stats(nets["resnet18"], "kl", reference=False)
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(5000), [60.0]]).astype(np.float32)
    out = calib.TensorStats()
    out.update_amax(x)
    out.update_hist(x)
    jout = jcalib.TensorStats()
    jout.update_amax(x)
    jout.update_hist(x)
    np.testing.assert_array_equal(out.hist, jout.hist)
    cases = [tq.stats["s3b1/out"], out]
    for st in cases:
        assert (calib.kl_threshold(st.hist, st.edges)
                == jcalib.kl_threshold(st.hist, st.edges))
        assert (calib.percentile_threshold(st.hist, st.edges)
                == jcalib.percentile_threshold(st.hist, st.edges))
        for method in ("kl", "percentile", "absmax"):
            assert st.scale(method) == jcalib.TensorStats(
                st.amax, st.hist, st.edges).scale(method)
    assert calib.absmax_scale(3.3, 4) == jcalib.absmax_scale(3.3, 4)
    assert calib.kl_threshold(out.hist, out.edges) < 0.5 * out.amax


@pytest.mark.parametrize("kind", ["counts", "spike", "weights", "sparse",
                                  "short"])
def test_kl_threshold_bit_equal_on_many_histograms(kind):
    """The port requantizes a candidate's bins a chunk per row of a 2-D
    view, not a chunk at a time: the same threshold as the reference's
    loop, bit for bit, on count histograms (a zero spike, sparse ones, few
    samples) and on float weights, every candidate length taking chunks
    of one to 17 bins."""
    rng = np.random.RandomState(len(kind))
    for trial in range(4):
        edges = np.linspace(0.0, rng.uniform(0.5, 8.0), calib.N_BINS + 1)
        if kind in ("counts", "spike", "short"):
            n = 300 if kind == "short" else 100_000
            x = np.abs(rng.standard_normal(n) * rng.uniform(0.1, 2.0))
            hist = np.histogram(x, bins=edges)[0].astype(np.float64)
            if kind == "spike":
                hist[0] += 40_000
        elif kind == "weights":
            hist = rng.random_sample(calib.N_BINS) ** 3 * 1e5
            hist[rng.random_sample(calib.N_BINS) < 0.3] = 0.0
        else:
            hist = np.zeros(calib.N_BINS)
            hist[rng.randint(0, calib.N_BINS, 40)] = rng.randint(1, 999, 40)
        assert (calib.kl_threshold(hist, edges)
                == jcalib.kl_threshold(hist, edges)), (kind, trial)


def test_actq_over_the_model(nets):
    """The taps' names and ranges, their percentile scales, and the logits
    of the fake-quantized forward (``apply`` mode, on the device with no
    host copy) close to the reference's."""
    n = nets["resnet18"]
    tq, jq = _tap_stats(n, "percentile")
    assert list(tq.stats) == list(jq.stats)
    for k in jq.stats:
        assert tq.stats[k].amax == pytest.approx(jq.stats[k].amax, rel=1e-5)
    tq.finalize()
    jq.finalize()
    for k in jq.scales:
        assert tq.scales[k] == pytest.approx(jq.scales[k], rel=2e-3), k
    jl, _ = jax.jit(lambda v, x: jcnn.cnn_apply(n["jcfg"], v, x, actq=jq))(
        n["jv"], jnp.asarray(n["x"]))
    tq.scales = dict(jq.scales)
    with torch.no_grad():
        tl, _ = cnn.cnn_apply(n["cfg"], n["tv"], torch.from_numpy(n["x"]),
                              actq=tq)
    # a code may move one step where an activation sits at a rounding
    # boundary; one step of the largest tap scale bounds it at the logits
    step = max(jq.scales.values())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=4 * step * np.abs(np.asarray(jl)).max())


# ------------------------------------------------------------------ quantization
@pytest.mark.parametrize("arch,gran", [("resnet18", "tensor"),
                                      ("resnet18", "channel"),
                                      ("mobilenetv3s", "tensor")])
def test_fake_quant_tree_within_one_step(nets, arch, gran):
    n = nets[arch]
    tf = cq.fake_quant_tree(n["tv"], 8, gran)
    jf = jcq.fake_quant_tree(n["jv"], 8, gran)
    ft, fj, fv = flat(tf), flat(jf), flat(n["tv"])
    for path, want in fj.items():
        if want.ndim < 2 or want.size < cq.MIN_FAKE_SIZE:
            np.testing.assert_array_equal(ft[path], want)
            continue
        axes = tuple(range(want.ndim)) if gran == "tensor" \
            else tuple(range(want.ndim - 1))
        step = np.abs(fv[path]).max(axis=axes, keepdims=True) / 127
        assert np.all(np.abs(ft[path] - want) <= step * 1.0001), path
    assert cq.simulated_int8_bytes(tf) == jcq.simulated_int8_bytes(jf)
    assert (cq.simulated_quantized_fraction(tf)
            == jcq.simulated_quantized_fraction(jf))
