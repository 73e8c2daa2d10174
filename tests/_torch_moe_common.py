"""What the MoE test files share: the two MoE smoke archs, the
tolerances, one intra-op thread, tree helpers over the port's per-layer
tree and the JAX package's stacked one, and ``base``: both configs, the
JAX params (seed 0) and the port's copy, and the launcher's calibration
batch in both frameworks.

Tolerances are those of ``test_torch_model.py`` and ``test_torch_hqp.py``
(hidden states a bf16 ulp a layer; logits within LOGIT_ATOL; S within
S_FRAC of its family's largest), with the MoE allowance of
``tests/test_system.py``: routing is discrete, and through a whole model a
token's router input differs from the reference's by the ulps the layers
below it left, so a token whose top-k lies a hair from the next expert may
take another one and move its row's hidden state and logits wholesale. So
at most MOE_OFF of the values may leave the tolerance, and greedy tokens
must equal the reference's wherever its top-2 logit gap exceeds TIE_GAP
(ROADMAP C2). Masks, rankings and artifacts are exact.

A test file imports the fixtures it uses (``base``, ``one_thread``) so
that pytest finds them in its namespace."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.serve import _calib_batch as j_calib_batch
from repro.models import lm as jlm
from repro.sharding.ctx import default_ctx
from repro_torch import configs
from repro_torch.compress import QuantizedLinear
from repro_torch.launch import serve
from repro_torch.weights import from_jax_params

MOE = ("phi3.5-moe-42b-a6.6b", "arctic-480b")
HIDDEN = dict(rtol=2 ** -7, atol=6.25e-2)
LOGIT_ATOL = 2e-2
S_FRAC = 2e-2
MOE_OFF = 0.05
TIE_GAP = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while a file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=MOE)
def base(request):
    arch = request.param
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, cfg=cfg, ctx=default_ctx(), jp=jp,
                tp=from_jax_params(np_tree(jp), device="cpu"),
                jb=j_calib_batch(jcfg, 2, 32),
                tb=serve._calib_batch(cfg, 2, 32, device="cpu"))


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def jforward(jp, jcfg, tokens):
    return jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t})[0])(
        jp, jnp.asarray(tokens))


def assert_close_moe(got, want, rtol, atol, what=""):
    """Within ``rtol``/``atol`` but for at most MOE_OFF of the values."""
    off = np.abs(got - want) > atol + rtol * np.abs(want)
    assert off.mean() <= MOE_OFF, (what, off.mean(),
                                   float(np.abs(got - want).max()))


def layer(jtree, g):
    return jax.tree.map(lambda t: t[g], jtree["blocks"][0])


def leaves(t, j, where=""):
    """(where, port leaf, JAX leaf) pairs of a port layer tree and the
    matching JAX one."""
    if isinstance(t, QuantizedLinear):
        yield where + "/w_q", t.w_q, j.w_q
        yield where + "/scale", t.scale, j.scale
    elif isinstance(t, dict):
        assert sorted(t) == sorted(j), where
        for k in t:
            yield from leaves(t[k], j[k], f"{where}/{k}")
    else:
        yield where, t, j


def assert_same_params(tp, jp):
    """Every leaf of the port's per-layer tree equals the JAX stacked
    tree's, shape and values."""
    for g, blk in enumerate(tp["blocks"]):
        for where, t, j in leaves(blk, layer(jp, g), f"L{g}"):
            assert tuple(t.shape) == j.shape, where
            np.testing.assert_array_equal(f32(t), f32(j), err_msg=where)


def assert_greedy(got, want, what=""):
    """The port's greedy tokens equal the reference's wherever its top-2
    logit gap exceeds TIE_GAP."""
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > TIE_GAP
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided], err_msg=what)
