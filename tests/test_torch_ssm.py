"""The Mamba block (``repro_torch.models.ssm``) on the CPU, held against the
JAX package's ``repro.models.ssm`` on the same weights and inputs: its init,
its train route, its prefill route seeded with a state and its decode
route, at the reference's own tolerances (rtol = atol = 3e-2,
``tests/test_models.py``). Then the port's identity contract, which the
reference's two forms (a chunked associative scan, a sequential decode)
do not give: a decode step, a prefill chunk and a whole prompt give the
same bits however the prompt is cut. And fault C9: the reference's
chunked scan raises on a length that is not a multiple of its chunk, the
port runs every length and matches the reference where the reference
runs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

TOL = dict(rtol=3e-2, atol=3e-2)
D = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(chunk=16):
    kw = dict(name="t", family="ssm", n_layers=1, d_model=D, n_heads=2,
              n_kv_heads=2, d_ff=0, vocab_size=64)
    return (JModelConfig(**kw, ssm=JSSMConfig(d_state=8, d_conv=4, expand=2,
                                              chunk=chunk)),
            ModelConfig(**kw, ssm=SSMConfig(d_state=8, d_conv=4, expand=2,
                                            chunk=chunk)))


@pytest.fixture(scope="module")
def block():
    """The reference's seed-0 Mamba weights, and the port's copy."""
    jcfg, cfg = _cfgs()
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _x(b, s, seed=1):
    """bf16 inputs from a seed, in both frameworks (the same bits)."""
    x = np.random.RandomState(seed).randn(b, s, D).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16), xt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _state_np(st):
    return {k: _np(v) for k, v in st.items()}


def test_init_matches_reference_layout():
    """Every leaf of the port's init has the reference's shape and dtype;
    the deterministic leaves (dt bias, skip) equal its values, and a_log
    (log 1..n) within an f32 ulp: the two libraries' log round apart."""
    jcfg, cfg = _cfgs()
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    tp = ssm.mamba_init(torch.Generator().manual_seed(0), cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    np.testing.assert_array_equal(tp["d_skip"].numpy(),
                                  np.asarray(jp["d_skip"]))
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]),
                               rtol=2 ** -23, atol=0)
    np.testing.assert_array_equal(tp["dt_proj"]["b"].numpy(),
                                  np.asarray(jp["dt_proj"]["b"]))
    st = ssm.init_mamba_state(3, cfg)
    jst = jssm.init_mamba_state(3, jcfg)
    for k in ("h", "conv"):
        assert tuple(st[k].shape) == jst[k].shape
        assert st[k].dtype == torch.float32 and not st[k].any()


def test_train_route_matches_reference(block):
    jp, tp = block
    jcfg, cfg = _cfgs()
    jx, tx = _x(2, 32)
    yj, _ = jssm.mamba_forward(jp, jcfg, jx)
    yt, st = ssm.mamba_forward(tp, cfg, tx, batch_invariant=False)
    assert st is None and yt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)


def test_prefill_route_seeded_matches_reference(block):
    """A 16-token chunk from zero state, then a second 16-token chunk
    seeded with the first's state: outputs and states."""
    jp, tp = block
    jcfg, cfg = _cfgs()
    jx, tx = _x(2, 32, seed=2)
    jst, tst = jssm.init_mamba_state(2, jcfg), ssm.init_mamba_state(2, cfg)
    for lo in (0, 16):
        yj, jst = jssm.mamba_forward(jp, jcfg, jx[:, lo:lo + 16], jst)
        yt, tst = ssm.mamba_forward(tp, cfg, tx[:, lo:lo + 16], tst)
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
        for k, v in _state_np(jst).items():
            np.testing.assert_allclose(_np(tst[k]), v, **TOL, err_msg=k)


def test_decode_route_matches_reference(block):
    """Sixteen single-token steps from zero state against the reference's
    sequential decode form."""
    jp, tp = block
    jcfg, cfg = _cfgs()
    jx, tx = _x(2, 16, seed=3)
    jst, tst = jssm.init_mamba_state(2, jcfg), ssm.init_mamba_state(2, cfg)
    for t in range(16):
        yj, jst = jssm.mamba_forward(jp, jcfg, jx[:, t:t + 1], jst)
        yt, tst = ssm.mamba_forward(tp, cfg, tx[:, t:t + 1], tst)
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL,
                                   err_msg=f"step {t}")
    np.testing.assert_allclose(_np(tst["h"]), _np(jst["h"]), **TOL)


def _run_cuts(tp, cfg, tx, cuts):
    st = ssm.init_mamba_state(tx.shape[0], cfg)
    outs, lo = [], 0
    for n in cuts:
        y, st = ssm.mamba_forward(tp, cfg, tx[:, lo:lo + n], st)
        outs.append(y)
        lo += n
    return torch.cat(outs, 1), st


@pytest.mark.parametrize("cuts", [[1] * 21, [21], [5, 11, 5], [3, 1, 17],
                                  [8, 8, 5]],
                         ids=["decode", "whole", "5-11-5", "3-1-17",
                              "8-8-5"])
def test_routes_give_the_same_bits_however_cut(block, cuts):
    """The port's identity contract: however a 21-token prompt is cut into
    chunks (single-token decode steps included), every output and the
    final state equal the whole prompt's bit for bit, at batch 1 and at
    batch 3 (row 1 of a batch of 3 equals the same row alone)."""
    _, tp = block
    _, cfg = _cfgs()
    _, tx = _x(3, 21, seed=4)
    y_whole, st_whole = _run_cuts(tp, cfg, tx, [21])
    y, st = _run_cuts(tp, cfg, tx, cuts)
    assert torch.equal(y, y_whole)
    for k in ("h", "conv"):
        assert torch.equal(st[k], st_whole[k]), k
    y1, st1 = _run_cuts(tp, cfg, tx[1:2], cuts)
    assert torch.equal(y1, y_whole[1:2])
    assert torch.equal(st1["h"], st_whole["h"][1:2])


def test_train_route_is_the_zero_state_prefill(block):
    """The train route runs the same recurrence from zero state: its output
    equals the state route's up to the products' batching (the train
    route takes one product a projection), and with the batch-invariant
    products, bit for bit."""
    _, tp = block
    _, cfg = _cfgs()
    _, tx = _x(2, 12, seed=5)
    y_state, _ = ssm.mamba_forward(tp, cfg, tx, ssm.init_mamba_state(2, cfg))
    y_train, _ = ssm.mamba_forward(tp, cfg, tx)
    assert torch.equal(y_train, y_state)
    y_fast, _ = ssm.mamba_forward(tp, cfg, tx, batch_invariant=False)
    np.testing.assert_allclose(_np(y_fast), _np(y_state), rtol=2 ** -7,
                               atol=1e-2)


def test_c9_reference_raises_port_runs_every_length(block):
    """Fault C9: at chunk 32 the reference's chunked scan asserts that the
    length is a multiple of the chunk, so a 40-token prefill raises, on
    the train route and seeded with a state. The port's recurrence needs
    no chunk: at 32 and 64 tokens it matches the reference on both routes,
    and at 40 it gives the bits of 40 decode steps."""
    jp, tp = block
    jcfg, cfg = _cfgs(chunk=32)
    jx, tx = _x(1, 64, seed=6)
    with pytest.raises(AssertionError):
        jssm.mamba_forward(jp, jcfg, jx[:, :40])
    with pytest.raises(AssertionError):
        jssm.mamba_forward(jp, jcfg, jx[:, :40],
                           jssm.init_mamba_state(1, jcfg))
    for n in (32, 64):
        yj, jst = jssm.mamba_forward(jp, jcfg, jx[:, :n],
                                     jssm.init_mamba_state(1, jcfg))
        yt, tst = ssm.mamba_forward(tp, cfg, tx[:, :n],
                                    ssm.init_mamba_state(1, cfg))
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL, err_msg=str(n))
        np.testing.assert_allclose(_np(tst["h"]), _np(jst["h"]), **TOL)
        yj, _ = jssm.mamba_forward(jp, jcfg, jx[:, :n])
        yt, _ = ssm.mamba_forward(tp, cfg, tx[:, :n], batch_invariant=False)
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL, err_msg=str(n))
    y40, st40 = _run_cuts(tp, cfg, tx[:, :40], [40])
    y_dec, st_dec = _run_cuts(tp, cfg, tx[:, :40], [1] * 40)
    assert torch.equal(y40, y_dec) and torch.equal(st40["h"], st_dec["h"])


def test_chunk_field_is_not_read(block):
    """``SSMConfig.chunk`` is kept as a field; the port's output does not
    depend on it."""
    _, tp = block
    _, tx = _x(1, 24, seed=7)
    ys = [ssm.mamba_forward(tp, _cfgs(chunk)[1], tx)[0] for chunk in (4, 256)]
    assert torch.equal(ys[0], ys[1])


def test_compacted_width_is_read_from_the_params(block):
    """A block whose channels were cut (a narrower ``conv_w``) runs at its
    own width: its state and output shapes follow ``conv_w``."""
    _, tp = block
    _, cfg = _cfgs()
    keep = torch.arange(0, 2 * D, 2)
    d_in = 2 * D
    cut = dict(tp)
    cut["conv_w"] = tp["conv_w"][:, keep]
    cut["x_proj"] = {"w": tp["x_proj"]["w"][keep]}
    cut["out_proj"] = {"w": tp["out_proj"]["w"][keep]}
    cut["dt_proj"] = {"w": tp["dt_proj"]["w"][:, keep],
                      "b": tp["dt_proj"]["b"][keep]}
    cut["a_log"], cut["d_skip"] = tp["a_log"][keep], tp["d_skip"][keep]
    cut["in_proj"] = {"w": tp["in_proj"]["w"][:, torch.cat([keep,
                                                            keep + d_in])]}
    st = ssm.init_mamba_state(2, cfg, d_in=keep.numel())
    _, tx = _x(2, 5, seed=8)
    y, st = ssm.mamba_forward(cut, cfg, tx, st)
    assert y.shape == (2, 5, D) and st["h"].shape == (2, keep.numel(), 8)
    assert st["conv"].shape == (2, 3, keep.numel())
    assert torch.isfinite(y.float()).all()


def test_state_is_not_written(block):
    """``mamba_forward`` returns a new state and leaves the one it was
    given as it was: the caller decides where a state is kept."""
    _, tp = block
    _, cfg = _cfgs()
    st = ssm.init_mamba_state(1, cfg)
    st["h"].add_(0.5)
    before = {k: v.clone() for k, v in st.items()}
    _, tx = _x(1, 3, seed=9)
    _, new = ssm.mamba_forward(tp, cfg, tx, st)
    for k in ("h", "conv"):
        assert torch.equal(st[k], before[k])
        assert not torch.equal(new[k], before[k])


def test_causal_conv_sums_taps_in_order():
    """The conv's K taps summed in order 0..K-1: equal to the explicit
    sum, and causal (output t reads inputs t..t+K-1 of the padded
    sequence)."""
    gen = torch.Generator().manual_seed(0)
    xpad = torch.randn(2, 3 + 6, 5, generator=gen)
    w = torch.randn(4, 5, generator=gen)
    out = ssm.causal_conv(xpad, w)
    want = torch.zeros(2, 6, 5)
    for t in range(6):
        acc = xpad[:, t] * w[0]
        for i in range(1, 4):
            acc = acc + xpad[:, t + i] * w[i]
        want[:, t] = acc
    assert torch.equal(out, want)
