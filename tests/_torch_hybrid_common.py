"""What the hybrid test files share: the jamba smoke config and its
period-2, 2-group variant (``DEEP``), both packages' seed-0 params
(``make``), one intra-op thread, the tolerances, and tree helpers over the
port's per-layer tree and the JAX package's tree of one stacked dict per
period position.

Tolerances: the logits and hidden states with ``tests/test_system.py``'s
MoE allowance (routing is discrete: through a whole model a token's router
input differs from the reference's by the ulps the layers below it left,
so a token a hair from the next expert may take another one), greedy
tokens equal wherever the reference's top-2 gap exceeds TIE_GAP (ROADMAP
C2), masks, rankings and artifacts exact (INT8 codes of the two packages'
own PTQ up to ROADMAP C1).

A test file imports the fixtures it uses (``one_thread``) so that pytest
finds them in its namespace."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sensitivity as jsens
from repro.launch.serve import _calib_batch as j_calib_batch
from repro.models import lm as jlm
from repro.sharding.ctx import default_ctx
from repro_torch import configs
from repro_torch.compress import QuantizedLinear
from repro_torch.core import sensitivity as sens
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.weights import from_jax_params

ARCH = "jamba-1.5-large-398b"
DEEP = dict(n_layers=4, block_pattern=("mamba", "attn") * 2)
TIE_GAP = 2e-2
C1_CODES = 1e-3
HIDDEN = dict(rtol=2 ** -7, atol=6.25e-2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def make(**over):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, cfg=cfg, ctx=default_ctx(), jp=jp,
                tp=from_jax_params(np_tree(jp), device="cpu"))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close_moe(got, want):
    """``tests/test_system.py``'s ``_assert_logits_close`` for an MoE
    config: at most 5 % of the values off by more than 0.15 + 0.15 |want|,
    and the median difference under 0.05."""
    diff = np.abs(got - want)
    assert np.mean(diff > 0.15 + 0.15 * np.abs(want)) <= 0.05, diff.max()
    assert float(np.median(diff)) < 0.05


def assert_greedy(got, want, what=""):
    """Greedy tokens equal wherever the reference's top-2 gap exceeds
    TIE_GAP (ROADMAP C2)."""
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > TIE_GAP
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided], err_msg=what)


def _leaves(t, j, where=""):
    if isinstance(t, QuantizedLinear):
        yield where + "/w_q", t.w_q, j.w_q
        yield where + "/scale", t.scale, j.scale
    elif isinstance(t, dict):
        assert sorted(t) == sorted(j), where
        for k in t:
            yield from _leaves(t[k], j[k], f"{where}/{k}")
    else:
        yield where, t, j


def assert_same_params(tp, jp, period, c1=False):
    """Every leaf of the port's per-layer tree equals the JAX tree's at
    ``blocks[i % period][i // period]``, shape and bits. With ``c1`` (two
    packages' PTQ of the same weights) an INT8 code may sit one step off
    on at most C1_CODES of a linear's codes and a scale one f32 ulp off:
    the jitted reference divides by a multiply with a reciprocal
    (ROADMAP C1)."""
    assert len(jp["blocks"]) == period
    for i, blk in enumerate(tp["blocks"]):
        jl = jax.tree.map(lambda t: t[i // period], jp["blocks"][i % period])
        for where, t, j in _leaves(blk, jl, f"L{i}"):
            assert tuple(t.shape) == tuple(j.shape), where
            a, b = f32(t), f32(j)
            if c1 and where.endswith("/w_q"):
                off = a != b
                assert off.mean() <= C1_CODES, where
                assert np.abs(a - b).max() <= 1, where
            elif c1 and where.endswith("/scale"):
                np.testing.assert_allclose(a, b, rtol=2 ** -23, atol=0,
                                           err_msg=where)
            else:
                np.testing.assert_array_equal(a, b, err_msg=where)
    for k in tp:
        if k != "blocks":
            for where, t, j in _leaves(tp[k], jp[k], k):
                np.testing.assert_array_equal(f32(t), f32(j), err_msg=where)


def jforward(jp, jcfg, tokens):
    return jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t})[0])(
        jp, jnp.asarray(tokens))


def jfisher(d, jp=None):
    """The reference's Fisher diagonal of ``make``'s model (or of ``jp``)
    on the launcher's calibration batch; the jitted gradient is kept in
    ``d``, so a second call does not compile again."""
    jcfg, ctx = d["jcfg"], d["ctx"]
    if "jgrad" not in d:
        d["jgrad"] = jax.jit(jax.grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b, ctx, with_aux=False)[0]))
    grad = d["jgrad"]
    return jsens.fisher_diag(grad, d["jp"] if jp is None else jp,
                             [j_calib_batch(jcfg, 2, 32)])[0]


def tfisher(d):
    """The port's own Fisher pass (autograd through its train route) on
    the same batch."""
    cfg = d["cfg"]
    return sens.fisher_diag(
        sens.loss_grad_fn(lambda p, b: lm.loss_fn(p, cfg, b)), d["tp"],
        [serve._calib_batch(cfg, 2, 32, device="cpu")])[0]
