"""The port's MoE layer (``models/moe.py``) against the JAX package's
``moe_forward`` under ``default_ctx()`` on the phi3.5-moe and arctic smoke
configs, same weights and inputs: its init, its chunked PTQ, its routing
and its output, arctic's dense residual MLP included, and its batch
invariance.

Routing is discrete, so the rule is per token: wherever the reference's
2nd and 3rd routing probabilities lie more than ROUTE_GAP apart, the port
picks the same experts, with gates within GATE_TOL, and its output row is
within a bf16 ulp (rtol 2^-7) of the reference's; the near-tie tokens may
route otherwise and must be at most MAX_NEAR_TIE of all
(``tests/test_system.py`` allows 5 % of MoE logits to disagree)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compress import quantize as jq  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.compress import quantize as cq  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

MOE = ("phi3.5-moe-42b-a6.6b", "arctic-480b")
ROUTE_GAP = 1e-4
GATE_TOL = dict(rtol=1e-5, atol=1e-6)
ROW_TOL = dict(rtol=2 ** -7, atol=1e-6)
MAX_NEAR_TIE = 0.05
INT8_ROW_REL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=MOE)
def layer(request):
    """(JAX cfg, port cfg, JAX layer-0 block, the port's copy)."""
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, configs.get_smoke_config(arch),
            jax.tree.map(lambda t: t[0], jp["blocks"][0]), tp["blocks"][0])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(cfg, n, seed=0, x=None):
    if x is None:
        x = np.random.RandomState(seed).randn(n, cfg.d_model)
    x = np.asarray(x, np.float32).reshape(n, cfg.d_model)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _ref_routing(jmoe, xj, k):
    """The reference's step 1 (``moe._moe_local``): probabilities, top-k
    gates renormalised, expert ids."""
    logits = (jnp.dot(xj.astype(jnp.float32), jmoe["router"]["w"])
              + jmoe["router"]["b"])
    probs = jax.nn.softmax(logits, axis=-1)
    g, idx = jax.lax.top_k(probs, k)
    return (np.asarray(probs), np.asarray(g / jnp.sum(g, -1, keepdims=True)),
            np.asarray(idx))


def _decided(probs, k):
    """Tokens whose k-th and (k+1)-th probabilities lie > ROUTE_GAP apart."""
    top = np.sort(probs, -1)[:, ::-1]
    return top[:, k - 1] - top[:, k] > ROUTE_GAP


# ------------------------------------------------------------------ init
@pytest.mark.parametrize("arch", MOE)
def test_moe_init_shapes_and_per_expert_draw(arch):
    """Router f32 (d, E) and zero (E,), experts bf16 (E, d, ff) / (E, ff,
    d); drawn one expert at a time, the experts equal one whole draw of the
    leaf from the same generator state (He scale over the fan-in d or ff),
    as the reference's ``he_init(..., fan_in=...)``."""
    cfg = configs.get_smoke_config(arch)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = M.moe_init(torch.Generator().manual_seed(5), cfg)
    assert p["router"]["w"].shape == (d, e)
    assert p["router"]["w"].dtype == torch.float32
    assert torch.equal(p["router"]["b"], torch.zeros(e))
    for name, shape in (("gate", (e, d, ff)), ("up", (e, d, ff)),
                        ("down", (e, ff, d))):
        assert p[name]["w"].shape == shape and \
            p[name]["w"].dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(5)
    whole = {"router": L.he_init(gen, (d, e))}
    for name, (k_in, n_out) in (("gate", (d, ff)), ("up", (d, ff)),
                                ("down", (ff, d))):
        whole[name] = (torch.randn((e, k_in, n_out), generator=gen)
                       * (2.0 / k_in) ** 0.5).to(torch.bfloat16)
    assert torch.equal(p["router"]["w"], whole["router"])
    for name in M.EXPERT_KEYS:
        assert torch.equal(p[name]["w"], whole[name]), name
    blk = lm.init_params(cfg, seed=0, device="cpu")["blocks"][1]
    assert set(blk) == {"norm1", "attn", "norm2", "moe"} | (
        {"mlp"} if cfg.moe.dense_residual else set())


def test_chunked_quantize_equals_whole_and_reference(layer):
    """``quantize_linear`` on a stacked expert leaf, one expert at a time,
    gives the codes and scales of one per-output-channel quantization of
    the whole leaf, and of the reference's quantizer run eagerly."""
    jcfg, cfg, jblk, tblk = layer
    for name in M.EXPERT_KEYS:
        w = tblk["moe"][name]["w"]
        got = cq.quantize_linear(tblk["moe"][name])
        q, s = cq.symmetric_quantize(w, 8, dims=(1,))
        assert got.w_q.shape == w.shape and got.scale.shape == (
            w.shape[0], w.shape[2])
        assert torch.equal(got.w_q, q.to(torch.int8))
        assert torch.equal(got.scale, s[:, 0])
        jqq, js = jq.symmetric_quantize.__wrapped__(jblk["moe"][name]["w"],
                                                    8, (1,))
        np.testing.assert_array_equal(got.w_q.numpy(),
                                      np.asarray(jqq, np.int8))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(js[:, 0]))
    tq = cq.quantize_lm_params({"blocks": [tblk]})["blocks"][0]
    assert isinstance(tq["moe"]["down"], QuantizedLinear)
    assert tq["moe"]["router"]["w"].dtype == torch.float32


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_moe_layer_matches_reference(layer, quantized):
    """The layer's output per token, by the routing rule (module doc),
    from bf16 and from INT8 experts (the reference quantized, the port
    given its codes: from equal inputs the W8A8 products are exact)."""
    jcfg, cfg, jblk, tblk = layer
    jmoe, tmoe = jblk["moe"], tblk["moe"]
    if quantized:
        jmoe = jq.quantize_lm_params({"moe": jmoe})["moe"]
        tmoe = from_jax_params(jax.tree.map(np.asarray, {"moe": jmoe}),
                               device="cpu")["moe"]
        assert isinstance(tmoe["gate"], QuantizedLinear)
    k = cfg.moe.experts_per_token
    xj, xt = _inputs(cfg, 64)
    yj, _ = jax.jit(lambda p, x: JM.moe_forward(p, jcfg, x, default_ctx()))(
        jmoe, xj.reshape(4, 16, -1))
    yt = M.moe_forward(tmoe, cfg, xt.reshape(4, 16, -1))
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == yj.shape
    probs, gates, idx = _ref_routing(jmoe, xj, k)
    tg, ti = M.route(xt, tmoe["router"], k)
    ok = _decided(probs, k)
    assert 1 - ok.mean() <= MAX_NEAR_TIE
    np.testing.assert_array_equal(ti.numpy()[ok], idx[ok])
    np.testing.assert_allclose(tg.numpy()[ok], gates[ok], **GATE_TOL)
    a, b = _f32(yj).reshape(64, -1)[ok], _f32(yt).reshape(64, -1)[ok]
    if not quantized:
        np.testing.assert_allclose(b, a, **ROW_TOL)
        return
    # under jit XLA quantizes the activations through a multiply by
    # fl(1/127) (ROADMAP C1): a code may sit one step off the port's
    rel = np.linalg.norm(b - a, axis=-1) / np.linalg.norm(a, axis=-1)
    assert rel.max() <= INT8_ROW_REL, rel.max()
    # eagerly the reference divides, and the expert SwiGLU over a dispatch
    # buffer (zero rows included) is then exact
    xb = np.random.RandomState(4).randn(cfg.moe.n_experts, 6, cfg.d_model)
    xb[:, 4:] = 0
    xbj, xbt = _inputs(cfg, xb.size // cfg.d_model, seed=None, x=xb)
    np.testing.assert_array_equal(
        _f32(M.expert_ffn(xbt.reshape(xb.shape), tmoe)),
        _f32(JM._expert_ffn(xbj.reshape(xb.shape), jmoe)))


def test_ffn_with_dense_residual_matches_reference(layer):
    """A block's FFN half, x + FFN(norm2(x)): the experts alone (phi3.5),
    or the experts plus the dense residual MLP added in bf16 (arctic), as
    the reference's ``lm._ffn_part``."""
    jcfg, cfg, jblk, tblk = layer
    xj, xt = _inputs(cfg, 32, seed=1)
    xj, xt = xj.reshape(2, 16, -1), xt.reshape(2, 16, -1)
    yj, _ = jax.jit(lambda p, x: jlm._ffn_part(p, jcfg, x, True,
                                               default_ctx(), False))(jblk, xj)
    yt = xt + lm.ffn(tblk, cfg, L.rmsnorm(xt, tblk["norm2"], cfg.norm_eps),
                      True)
    hj = jlm.L.rmsnorm(xj, jblk["norm2"], jcfg.norm_eps).reshape(32, -1)
    probs, _, _ = _ref_routing(jblk["moe"], hj, cfg.moe.experts_per_token)
    ok = _decided(probs, cfg.moe.experts_per_token)
    assert 1 - ok.mean() <= MAX_NEAR_TIE
    # the norm may round one ulp apart, and the sums then another
    np.testing.assert_allclose(_f32(yt).reshape(32, -1)[ok],
                               _f32(yj).reshape(32, -1)[ok],
                               rtol=2 ** -6, atol=2e-2)
    assert ("mlp" in tblk) == cfg.moe.dense_residual


def test_moe_is_batch_invariant_and_ties_go_to_the_lower_expert(layer):
    """Serving route: each token's output is the same bits whether it is
    routed alone or among others; and experts of equal probability (masked
    experts all score exactly 0) are taken in ascending id, as
    ``lax.top_k`` takes them."""
    _, cfg, _, tblk = layer
    _, xt = _inputs(cfg, 12, seed=3)
    k = cfg.moe.experts_per_token
    whole = M.moe_tokens(xt, tblk["moe"], k)
    for i in range(12):
        assert torch.equal(M.moe_tokens(xt[i:i + 1], tblk["moe"], k),
                           whole[i:i + 1]), i
    e = cfg.moe.n_experts
    router = {"w": torch.zeros((cfg.d_model, e)),
              "b": torch.tensor([0.0] * (e - 1) + [1.0])}
    _, idx = M.route(xt, router, k)
    assert (idx[:, 0] == e - 1).all() and (idx[:, 1] == 0).all()
