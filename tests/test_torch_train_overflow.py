"""ROADMAP C14: the gradient of the port's ``silu``, ``sigmoid`` and
``tanh`` where their ``exp`` overflows, held against the reference's
``jax.nn.silu``, ``jax.nn.sigmoid`` and ``jnp.tanh``.

They are built from ``exp`` (``models/layers.py``). Where exp(-a)
overflows to inf (a below about -88, or -44 for tanh's exp(-2a)) the value
saturates, and autograd's backward through the inf gave 0·inf = NaN, where
the reference's derivative is 0: a finite loss with a NaN gradient, which
the global clip then spreads to every param. Held: the gradient at such
inputs finite and equal to the reference's 0, the values and the
gradients elsewhere the same bits as the plain expressions, and a jamba
smoke model whose MLP gate is scaled into overflow: its gradient finite
where the reference's is."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_train_common import (LOSS_RTOL, ctx, flat_port,  # noqa: E402,F401
                                 flat_ref, make, one_thread)

from repro.models import lm as jlm  # noqa: E402
from repro_torch.core.sensitivity import value_and_grad  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402

INPUTS = [-1e4, -200.0, -100.0, -60.0, -45.0, -20.0, -1.0, 0.0, 0.5, 3.0,
          45.0, 100.0, 1e4]
# (port, reference, the plain expression, the inputs where its exp
# overflows: exp(-a) past a = -88.7, exp(-2a) past -44.4)
FUNCS = {"silu": (L.silu, jax.nn.silu,
                  lambda a: a * (1.0 / (1.0 + torch.exp(-a))), -88.8),
         "sigmoid": (L.sigmoid, jax.nn.sigmoid,
                     lambda a: 1.0 / (1.0 + torch.exp(-a)), -88.8),
         "tanh": (L.tanh, jnp.tanh,
                  lambda a: 2.0 / (1.0 + torch.exp(-2.0 * a)) - 1.0, -44.4)}
SCALE = 2e3
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FUNCS)
def test_c14_gradient_where_exp_overflows(name, dtype):
    """The gradient finite at every input, and where exp overflows equal to
    the reference's: 0."""
    port, ref, plain, edge = FUNCS[name]
    tdt, jdt = DTYPES[dtype]
    a = torch.tensor(INPUTS, dtype=tdt, requires_grad=True)
    got, = torch.autograd.grad(port(a).float().sum(), a)
    want = jax.grad(lambda x: ref(x).astype(jnp.float32).sum())(
        jnp.asarray(INPUTS, jdt))
    over = np.asarray(INPUTS) < edge
    assert torch.isfinite(got).all(), got
    np.testing.assert_array_equal(got.float().numpy()[over],
                                  np.asarray(want, np.float32)[over])
    # the plain expression's gradient is NaN there (the fault)
    b = torch.tensor(INPUTS, dtype=tdt, requires_grad=True)
    plain_g, = torch.autograd.grad(plain(b).float().sum(), b)
    assert torch.isnan(plain_g[torch.from_numpy(over)]).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FUNCS)
def test_c14_same_bits_where_exp_is_finite(name, dtype):
    """Values everywhere and gradients where exp does not overflow: the same
    bits as the plain expression, with autograd and without."""
    port, _, plain, _ = FUNCS[name]
    tdt = DTYPES[dtype][0]
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32) * 30).to(tdt)
    with torch.no_grad():
        assert torch.equal(port(x), plain(x))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya, yb = port(a), plain(b)
    assert torch.equal(ya, yb)
    w = torch.from_numpy(np.random.RandomState(1).randn(4096)
                         .astype(np.float32)).to(tdt)
    ga, = torch.autograd.grad((ya * w).float().sum(), a)
    gb, = torch.autograd.grad((yb * w).float().sum(), b)
    finite = torch.isfinite(gb)
    assert finite.float().mean() > 0.9
    assert torch.equal(ga[finite], gb[finite])


def test_c14_jamba_gradient_finite_past_overflow():
    """The jamba smoke model with its first layer's MLP gate scaled by
    SCALE, so that its SwiGLU gate's pre-activations run past exp's range:
    the reference's loss gradient is finite, and so is the port's, the loss
    within LOSS_RTOL."""
    family = make("jamba-1.5-large-398b")
    jcfg, cfg, toks = family["jcfg"], family["cfg"], family["tokens"]
    jp = jax.tree.map(lambda t: t, family["jp"])
    blk = dict(jp["blocks"][0])
    blk["mlp"] = {**blk["mlp"], "gate": {"w": (blk["mlp"]["gate"]["w"]
                                               * SCALE)}}
    jp["blocks"] = (blk,) + tuple(jp["blocks"][1:])
    tp = dict(family["tp"])
    tp["blocks"] = list(tp["blocks"])
    tb = dict(tp["blocks"][0])
    tb["mlp"] = {**tb["mlp"], "gate": {"w": tb["mlp"]["gate"]["w"] * SCALE}}
    tp["blocks"][0] = tb
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t: jlm.loss_fn(
        p, jcfg, {"tokens": t}, ctx(False), with_aux=True)[0]))(
        jp, jnp.asarray(toks, jnp.int32))
    tl, tg = value_and_grad(lambda p, b: lm.loss_fn(
        p, cfg, b, with_aux=True, moe_no_drop=False)[0])(
        tp, {"tokens": torch.as_tensor(toks)})
    want, got = flat_ref(jg), flat_port(tg)
    assert all(np.isfinite(v).all() for v in want.values())
    with torch.no_grad():
        h = L.rmsnorm(torch.randn(4, cfg.d_model).to(torch.bfloat16),
                      tb["norm2"], cfg.norm_eps)
        pre = L.dense(h, tb["mlp"]["gate"])
    assert float(pre.float().min()) < -100       # past exp's range
    bad = [k for k, v in got.items() if not np.isfinite(v).all()]
    assert not bad, bad
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
