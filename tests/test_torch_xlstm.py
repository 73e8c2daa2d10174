"""The xLSTM blocks (``repro_torch.models.xlstm``) on the CPU, held against
the JAX package's ``repro.models.xlstm`` on the same weights and inputs:
their init; the mLSTM's decode route against the reference's decode (its
chunk-1 form) within one bf16 step; its prefill and train routes against
the reference's chunkwise form within the rule the reference holds its
own two forms to (``_torch_xlstm_common``); the sLSTM on every route.
Then the port's identity contract: a decode step, a prefill chunk and a
whole prompt give the same bits however the prompt is cut, and a row of
a batch the bits it has alone. And fault C10: the reference's chunkwise
mLSTM raises on a length that is not a multiple of its chunk; the port
runs every length and matches the reference where the reference runs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_xlstm_common import (STEP, assert_close_system,  # noqa: E402,F401
                                 one_thread)
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import XLSTMConfig as JXLSTMConfig  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.configs.base import ModelConfig, XLSTMConfig  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

D = 32
KINDS = ("mlstm", "slstm")
STATE_KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("h", "c", "n", "m")}


def _cfgs(kind, chunk=16):
    kw = dict(name="t", family="ssm", n_layers=1, d_model=D, n_heads=2,
              n_kv_heads=2, d_ff=0, vocab_size=64, block_pattern=(kind,))
    return (JModelConfig(**kw, xlstm=JXLSTMConfig(chunk=chunk)),
            ModelConfig(**kw, xlstm=XLSTMConfig(chunk=chunk)))


class Block:
    """One block kind in both packages: the reference's seed-``seed``
    weights and the port's copy, each package's forward and zero state."""

    def __init__(self, kind, seed=0, chunk=16):
        self.kind = kind
        self.jcfg, self.cfg = _cfgs(kind, chunk)
        init = getattr(jxl, f"{kind}_init")
        self.jp = init(jax.random.PRNGKey(seed), self.jcfg)
        self.tp = from_jax_params(jax.tree.map(np.asarray, self.jp),
                                  device="cpu")
        fwd = getattr(jxl, f"{kind}_forward")
        self._jit = jax.jit(lambda p, x, st: fwd(p, self.jcfg, x, st))

    def jfwd(self, x, state=None):
        """The reference's forward, jitted (one compile a shape)."""
        return self._jit(self.jp, x, state)

    def tfwd(self, x, state=None, **kw):
        return getattr(xlstm, f"{self.kind}_forward")(self.tp, self.cfg, x,
                                                      state, **kw)

    def jstate(self, b):
        fn = getattr(jxl, f"init_{self.kind}_state")
        return fn(b, self.jcfg)

    def tstate(self, b):
        fn = getattr(xlstm, f"init_{self.kind}_state")
        return fn(b, self.cfg)

    def jstate_dict(self, st):
        return dict(zip(STATE_KEYS[self.kind], st))


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def mlstm(request):
    return Block("mlstm", request.param)


@pytest.fixture(scope="module")
def blocks():
    return {k: Block(k) for k in KINDS}


def _x(b, s, seed=1):
    """bf16 inputs from a seed, in both frameworks (the same bits)."""
    x = np.random.RandomState(seed).randn(b, s, D).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16), xt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_state(tst, jst_dict, what=""):
    """A state within f32 rounding of the reference's (the two packages'
    f32 sums run in other orders): 1e-5 of each leaf's largest value."""
    for k, v in jst_dict.items():
        want = _np(v)
        np.testing.assert_allclose(
            _np(tst[k]), want, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(want).max()), 1.0),
            err_msg=f"{what} {k}")


# ------------------------------------------------------------------ init
@pytest.mark.parametrize("kind", KINDS)
def test_init_matches_reference_layout(kind):
    """Every leaf of the port's init has the reference's shape and dtype;
    the deterministic leaves (gate biases, norm scales) equal its values;
    the zero states have the reference's shapes and keys in order."""
    jcfg, cfg = _cfgs(kind)
    jp = getattr(jxl, f"{kind}_init")(jax.random.PRNGKey(0), jcfg)
    tp = getattr(xlstm, f"{kind}_init")(torch.Generator().manual_seed(0),
                                       cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: 0, tp)))
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
        if path[-1].key in ("b", "g") or path[-1].key.startswith("b_"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf),
                                          err_msg=str(path))
    jst = getattr(jxl, f"init_{kind}_state")(3, jcfg)
    tst = getattr(xlstm, f"init_{kind}_state")(3, cfg)
    assert tuple(tst) == STATE_KEYS[kind]
    for k, v in zip(STATE_KEYS[kind], jst):
        assert tuple(tst[k].shape) == v.shape, k
        assert tst[k].dtype == torch.float32 and not tst[k].any()
    assert not {"k", "k_q"} & set(tst)


# ------------------------------------------------------------------ mLSTM
def test_mlstm_decode_route_matches_reference(mlstm):
    """48 single-token steps from zero state against the reference's
    decode (its chunkwise code at chunk 1): every output within one bf16
    step, and the state after them within f32 rounding."""
    jx, tx = _x(2, 48, seed=3)
    jst, tst = mlstm.jstate(2), mlstm.tstate(2)
    for t in range(48):
        yj, jst = mlstm.jfwd(jx[:, t:t + 1], jst)
        yt, tst = mlstm.tfwd(tx[:, t:t + 1], tst)
        np.testing.assert_allclose(_np(yt), _np(yj), **STEP,
                                   err_msg=f"step {t}")
    _close_state(tst, mlstm.jstate_dict(jst))


def test_mlstm_prefill_and_train_routes_match_reference(mlstm):
    """The train route (chunkwise, as the reference's, chunk 16 over 48
    positions) and the prefill route (the port's stepped form, seeded with
    the state of a first 16-token chunk) against the reference's chunkwise
    form, within the rule the reference holds its own two forms to."""
    jx, tx = _x(2, 48, seed=4)
    yj, _ = mlstm.jfwd(jx)
    yt, st = mlstm.tfwd(tx, batch_invariant=False)
    assert st is None and yt.dtype == torch.bfloat16
    assert_close_system(_np(yt), _np(yj))
    jst, tst = mlstm.jstate(2), mlstm.tstate(2)
    for lo, n in ((0, 16), (16, 32)):
        yj, jst = mlstm.jfwd(jx[:, lo:lo + n], jst)
        yt, tst = mlstm.tfwd(tx[:, lo:lo + n], tst)
        assert_close_system(_np(yt), _np(yj))
    for k, v in mlstm.jstate_dict(jst).items():
        assert_close_system(_np(tst[k]), _np(v))


def test_mlstm_reference_own_forms_differ_as_the_ports(mlstm):
    """The port's prefill route is the reference's chunk-1 form: its gap
    to the reference's chunkwise form is the reference's own gap between
    its two forms, within one bf16 step."""
    jx, tx = _x(2, 32, seed=5)
    y16, _ = mlstm.jfwd(jx)
    y1, _ = jxl.mlstm_forward(mlstm.jp, _cfgs("mlstm", chunk=1)[0], jx)
    yt, _ = mlstm.tfwd(tx, mlstm.tstate(2))
    np.testing.assert_allclose(_np(yt), _np(y1), **STEP)
    gap_ref = np.abs(_np(y1) - _np(y16)).max()
    gap_port = np.abs(_np(yt) - _np(y16)).max()
    assert gap_port <= gap_ref + 2 ** -6, (gap_port, gap_ref)


# ------------------------------------------------------------------ sLSTM
def test_slstm_matches_reference_on_every_route(blocks):
    """The train route, a prefill chunk seeded with a state, and decode
    steps against the reference's one stepped form: outputs within one
    bf16 step, states within f32 rounding."""
    blk = blocks["slstm"]
    jx, tx = _x(2, 24, seed=6)
    yj, _ = blk.jfwd(jx)
    yt, st = blk.tfwd(tx, batch_invariant=False)
    assert st is None
    np.testing.assert_allclose(_np(yt), _np(yj), **STEP)
    jst, tst = blk.jstate(2), blk.tstate(2)
    yj, jst = blk.jfwd(jx[:, :16], jst)
    yt, tst = blk.tfwd(tx[:, :16], tst)
    np.testing.assert_allclose(_np(yt), _np(yj), **STEP)
    for t in range(16, 24):
        yj, jst = blk.jfwd(jx[:, t:t + 1], jst)
        yt, tst = blk.tfwd(tx[:, t:t + 1], tst)
        np.testing.assert_allclose(_np(yt), _np(yj), **STEP,
                                   err_msg=f"step {t}")
    _close_state(tst, blk.jstate_dict(jst))


def test_slstm_state_carries_across_a_cut(blocks):
    """The reference's ``test_slstm_state_carries`` in the port: 12 tokens
    whole equal 6 then 6 from the carried state, bit for bit, and the
    reference's whole run within its own tolerance there (3e-2)."""
    blk = blocks["slstm"]
    jx, tx = _x(1, 12, seed=7)
    y_whole, st_whole = blk.tfwd(tx, blk.tstate(1))
    y1, st = blk.tfwd(tx[:, :6], blk.tstate(1))
    y2, st = blk.tfwd(tx[:, 6:], st)
    assert torch.equal(torch.cat([y1, y2], 1), y_whole)
    for k in STATE_KEYS["slstm"]:
        assert torch.equal(st[k], st_whole[k]), k
    yj, _ = blk.jfwd(jx)
    np.testing.assert_allclose(_np(y_whole), _np(yj), rtol=3e-2, atol=3e-2)


# ------------------------------------------------------------------ identity
def _run_cuts(blk, tx, cuts):
    st = blk.tstate(tx.shape[0])
    outs, lo = [], 0
    for n in cuts:
        y, st = blk.tfwd(tx[:, lo:lo + n], st)
        outs.append(y)
        lo += n
    return torch.cat(outs, 1), st


@pytest.mark.parametrize("cuts", [[1] * 21, [5] * 4 + [1], [16, 5],
                                  [3, 1, 17]],
                         ids=["decode", "5s", "16-5", "3-1-17"])
@pytest.mark.parametrize("kind", KINDS)
def test_routes_give_the_same_bits_however_cut(blocks, kind, cuts):
    """The port's identity contract: however a 21-token prompt is cut into
    chunks (single-token decode steps included), every output and the
    final state equal the whole prompt's bit for bit, at batch 3; and a
    row of the batch of 3 equals the same row run alone."""
    blk = blocks[kind]
    _, tx = _x(3, 21, seed=8)
    y_whole, st_whole = _run_cuts(blk, tx, [21])
    y, st = _run_cuts(blk, tx, cuts)
    assert torch.equal(y, y_whole)
    for k in STATE_KEYS[kind]:
        assert torch.equal(st[k], st_whole[k]), k
    y1, st1 = _run_cuts(blk, tx[1:2], cuts)
    assert torch.equal(y1, y_whole[1:2])
    for k in STATE_KEYS[kind]:
        assert torch.equal(st1[k], st_whole[k][1:2]), k


# ------------------------------------------------------------------ C10
def test_c10_reference_raises_port_runs_every_length():
    """Fault C10: at chunk 32 the reference's chunkwise mLSTM asserts that
    the length is a multiple of the chunk, so 40 tokens raise, on the
    train route and seeded with a state. The port runs 32, 40 and 64: at
    32 and 64 it matches the reference on both routes; at 40 its train
    route (a chunk of 32, then one of 8) matches the reference at chunk 8
    (which 40 divides), and its prefill route gives the bits of 40 decode
    steps."""
    blk = Block("mlstm", chunk=32)
    jx, tx = _x(1, 64, seed=9)
    with pytest.raises(AssertionError):
        blk.jfwd(jx[:, :40])
    with pytest.raises(AssertionError):
        blk.jfwd(jx[:, :40], blk.jstate(1))
    for n in (32, 64):
        yj, jst = blk.jfwd(jx[:, :n], blk.jstate(1))
        yt, tst = blk.tfwd(tx[:, :n], blk.tstate(1))
        assert_close_system(_np(yt), _np(yj))
        yj, _ = blk.jfwd(jx[:, :n])
        yt, _ = blk.tfwd(tx[:, :n], batch_invariant=False)
        assert_close_system(_np(yt), _np(yj))
    y8, _ = jxl.mlstm_forward(blk.jp, _cfgs("mlstm", chunk=8)[0], jx[:, :40])
    yt, _ = blk.tfwd(tx[:, :40], batch_invariant=False)
    assert_close_system(_np(yt), _np(y8))
    y40, st40 = _run_cuts(blk, tx[:, :40], [40])
    y_dec, st_dec = _run_cuts(blk, tx[:, :40], [1] * 40)
    assert torch.equal(y40, y_dec)
    assert all(torch.equal(st40[k], st_dec[k]) for k in ("C", "n", "m"))


def test_chunk_shapes_the_train_route_only(blocks):
    """``XLSTMConfig.chunk`` sets the train route's chunks (a short last
    one where it does not divide the length); the routes that carry a
    state step every position whatever it says."""
    blk = blocks["mlstm"]
    _, tx = _x(1, 24, seed=10)
    ys = [xlstm.mlstm_forward(blk.tp, _cfgs("mlstm", chunk)[1], tx,
                              xlstm.init_mlstm_state(1, blk.cfg))[0]
          for chunk in (5, 256)]
    assert torch.equal(ys[0], ys[1])
    tr = [xlstm.mlstm_forward(blk.tp, _cfgs("mlstm", chunk)[1], tx)[0]
          for chunk in (5, 24)]
    assert_close_system(_np(tr[0]), _np(tr[1]))


# ------------------------------------------------------------------ widths
def test_compacted_width_is_read_from_the_params(blocks):
    """An mLSTM block with one of its two heads cut (every member of the
    ``mlstm_heads`` family narrowed) runs at its own width: its head count
    comes from ``in_proj`` and ``wq`` (the head width stays), its state
    from ``init_mlstm_state(d_in=...)``, and it computes what the full
    block computes with that head's members zeroed."""
    blk = blocks["mlstm"]
    tp, cfg = blk.tp, blk.cfg
    hd = xlstm.head_width(cfg)
    d_in = 2 * D
    keep = torch.arange(hd, 2 * hd)             # head 1
    cut = {k: tp[k][1:] for k in ("wq", "wk", "wv")}
    cut["w_i"] = {"w": tp["w_i"]["w"][keep][:, 1:], "b": tp["w_i"]["b"][1:]}
    cut["w_f"] = {"w": tp["w_f"]["w"][keep][:, 1:], "b": tp["w_f"]["b"][1:]}
    cut["norm"] = {"g": tp["norm"]["g"][keep]}
    cut["in_proj"] = {"w": tp["in_proj"]["w"][:, torch.cat([keep,
                                                            keep + d_in])]}
    cut["out_proj"] = {"w": tp["out_proj"]["w"][keep]}
    st = xlstm.init_mlstm_state(2, cfg, d_in=hd)
    assert st["C"].shape == (2, 1, hd, hd) and st["m"].shape == (2, 1)
    _, tx = _x(2, 7, seed=11)
    y, st = xlstm.mlstm_forward(cut, cfg, tx, st)
    assert y.shape == (2, 7, D) and st["n"].shape == (2, 1, hd)
    masked = {k: v.clone() if isinstance(v, torch.Tensor)
              else {kk: vv.clone() for kk, vv in v.items()}
              for k, v in tp.items()}
    for k in ("wq", "wk", "wv"):
        masked[k][0] = 0
    for g in ("w_i", "w_f"):
        masked[g]["w"][:, 0] = 0
        masked[g]["w"][:hd] = 0
        masked[g]["b"][0] = 0
    masked["norm"]["g"][:hd] = 0
    masked["in_proj"]["w"][:, :hd] = 0
    masked["in_proj"]["w"][:, d_in:d_in + hd] = 0
    masked["out_proj"]["w"][:hd] = 0
    ym, _ = xlstm.mlstm_forward(masked, cfg, tx,
                                xlstm.init_mlstm_state(2, cfg))
    np.testing.assert_allclose(_np(y), _np(ym), rtol=0, atol=2 ** -6)


@pytest.mark.parametrize("kind", KINDS)
def test_state_is_not_written(blocks, kind):
    """A forward returns a new state and leaves the one it was given as it
    was: the caller decides where a state is kept."""
    blk = blocks[kind]
    st = blk.tstate(1)
    for v in st.values():
        v.add_(0.5)
    before = {k: v.clone() for k, v in st.items()}
    _, tx = _x(1, 3, seed=12)
    _, new = blk.tfwd(tx, st)
    for k in STATE_KEYS[kind]:
        assert torch.equal(st[k], before[k]), k
        assert not torch.equal(new[k], before[k]), k


def test_head_matmul_rows_equal_one_row_calls():
    """``head_matmul``'s batch-invariant form: each row's bits are those of
    the same row alone, and within a bf16 rounding of the one-call form."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, 2, 16, generator=gen).to(torch.bfloat16)
    w = torch.randn(2, 16, 24, generator=gen).to(torch.bfloat16)
    out = xlstm.head_matmul(x, w, True)
    assert out.shape == (5, 3, 2, 24)
    for i in range(5):
        assert torch.equal(xlstm.head_matmul(x[i:i + 1], w, True), out[i:i + 1])
    np.testing.assert_allclose(_np(out), _np(xlstm.head_matmul(x, w, False)),
                               rtol=2 ** -7, atol=2 ** -7)
