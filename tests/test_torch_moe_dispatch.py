"""The MoE layer at the train capacity (``models/moe.py``) against the JAX
package's ``moe_forward`` under ``moe_no_drop=False`` on the phi3.5-moe and
arctic smoke configs, same weights and inputs, at the published capacity
factor 1.25 and at 0.5 (which drops pairs for sure): the placement of the
(token, expert) pairs (ranks, slots, drop masks), the output and the
auxiliary losses; then what the layer does with no expert and with fewer
experts than k (ROADMAP C12), that the inference-capacity path keeps its
bits, and that the backward of the dispatch repeats bit for bit.

Routing is discrete (``test_torch_moe.py``'s rule): wherever the
reference's k-th and (k+1)-th routing probabilities lie more than
ROUTE_GAP apart the port picks the same experts, and the near-tie tokens
must be at most MAX_NEAR_TIE of all. A pair's rank depends on the tokens
before it, so the placement is exact up to the first token that routes
otherwise (all of them unless a near tie flipped), and every output row
there within a bf16 ulp (rtol 2^-7). The reference's
placement is its ``_moe_local``'s lines, run by JAX on its own top-k."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

MOE = ("phi3.5-moe-42b-a6.6b", "arctic-480b")
ROUTE_GAP = 1e-4
ROW_TOL = dict(rtol=2 ** -7, atol=1e-6)
AUX_TOL = dict(rtol=1e-5, atol=0)
AUX_GRAD_TOL = 1e-4
MAX_NEAR_TIE = 0.05
N_TOKENS = 64


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
    """(JAX cfg, port cfg, JAX layer-0 MoE params, the port's copy)."""
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, configs.get_smoke_config(arch),
            jax.tree.map(lambda t: t[0], jp["blocks"][0])["moe"],
            tp["blocks"][0]["moe"])


def _with_cf(jcfg, cfg, cf):
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf)),
        dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf)))


def _inputs(cfg, n, seed=0):
    x = np.random.RandomState(seed).randn(n, cfg.d_model).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref_plan(jmoe, xj, k, e, cap):
    """The reference's routing and placement, ``_moe_local``'s lines on one
    shard: probabilities, then the token-major pairs' ranks in a stable
    sort by expert, each pair's slot (E·C for a drop) and kept mask, in
    token-major order."""
    logits = (jnp.dot(xj.astype(jnp.float32), jmoe["router"]["w"])
              + jmoe["router"]["b"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    n = xj.shape[0]
    flat_e = expert_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.bincount(flat_e, length=e)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(n * k) - starts[se]
    local = rank < cap
    slot = jnp.where(local, se * cap + rank, e * cap)
    inv = np.argsort(np.asarray(order))            # back to token-major
    return (np.asarray(probs), np.asarray(expert_idx), np.asarray(slot)[inv],
            np.asarray(local)[inv], np.asarray(counts))


def _decided(probs, k):
    """Tokens whose k-th and (k+1)-th probabilities lie > ROUTE_GAP apart,
    and the share of those that do not."""
    top = np.sort(probs, -1)[:, ::-1]
    ok = top[:, k - 1] - top[:, k] > ROUTE_GAP
    return ok, 1 - ok.mean()


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_train_capacity_matches_reference(layer, cf):
    jcfg, cfg, jmoe, tmoe = layer
    jcfg, cfg = _with_cf(jcfg, cfg, cf)
    k, e = cfg.moe.experts_per_token, cfg.moe.n_experts
    xj, xt = _inputs(cfg, N_TOKENS)
    cap = M.capacity(N_TOKENS, cfg)
    assert cap == JM._capacity(N_TOKENS, jcfg)
    assert cap < N_TOKENS
    probs, jidx, jslot, jlocal, jcounts = _ref_plan(jmoe, xj, k, e, cap)
    ok, near = _decided(probs, k)
    assert near <= MAX_NEAR_TIE
    _, tidx = M.route(xt, tmoe["router"], k, batch_invariant=False)
    np.testing.assert_array_equal(tidx.numpy()[ok], jidx[ok])
    # a pair's rank depends on the tokens before it: exact up to the first
    # token that routes otherwise (none, unless a near tie flipped)
    differ = (tidx.numpy() != jidx).any(-1)
    first = int(np.argmax(differ)) if differ.any() else N_TOKENS
    slot, local, counts = M.dispatch_plan(tidx, e, cap)
    pairs = first * k
    print(f"{cfg.name} cf {cf}: C {cap}, {int(jlocal.size - jlocal.sum())} "
          f"of {jlocal.size} pairs dropped, placement held on the first "
          f"{first} of {N_TOKENS} tokens")
    np.testing.assert_array_equal(slot.numpy()[:pairs], jslot[:pairs])
    np.testing.assert_array_equal(local.numpy()[:pairs], jlocal[:pairs])
    if first == N_TOKENS:
        np.testing.assert_array_equal(counts.numpy(), jcounts)
    if cf < 1:
        assert not jlocal.all()          # pairs were dropped
    ctx = dataclasses.replace(default_ctx(), moe_no_drop=False)
    yj, jaux = jax.jit(lambda p, x: JM.moe_forward(p, jcfg, x, ctx,
                                                   with_aux=True))(
        jmoe, xj.reshape(4, 16, -1))
    yt, taux = M.moe_layer(tmoe, cfg, xt.reshape(4, 16, -1),
                           batch_invariant=False, no_drop=False,
                           with_aux=True)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(_f32(yt).reshape(N_TOKENS, -1)[:first],
                               _f32(yj).reshape(N_TOKENS, -1)[:first],
                               **ROW_TOL)
    # a token all of whose pairs were dropped adds exactly 0
    gone = ~local.numpy().reshape(N_TOKENS, k).any(-1)
    assert not _f32(yt).reshape(N_TOKENS, -1)[gone].any()
    assert sorted(taux) == sorted(jaux)
    for name in taux:
        assert taux[name].dtype == torch.float32
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   err_msg=name, **AUX_TOL)


def test_aux_losses_are_the_switch_losses(layer):
    """load_balance = E·Σ f_e·P_e and router_z = mean(lse²), each times its
    weight; the counts before the drops; the gradient reaches the router
    through both, and none reaches the counts."""
    _, cfg, _, tmoe = layer
    k, e = cfg.moe.experts_per_token, cfg.moe.n_experts
    _, xt = _inputs(cfg, N_TOKENS, seed=2)
    w = tmoe["router"]["w"].clone().requires_grad_(True)
    router = {"w": w, "b": tmoe["router"]["b"]}
    logits, probs = M._router(xt, router, False)
    _, idx = M._top_k(probs, k, False)
    counts = M.expert_counts(idx.reshape(-1), e)
    assert int(counts.sum()) == N_TOKENS * k
    aux = M.aux_losses(logits, probs, counts, k, cfg)
    f = counts.double() / (N_TOKENS * k)
    lb = e * float((f * probs.detach().double().mean(0)).sum())
    z = float((torch.logsumexp(logits.detach().double(), -1) ** 2).mean())
    np.testing.assert_allclose(float(aux["load_balance"]),
                               lb * cfg.moe.load_balance_loss, rtol=1e-6)
    np.testing.assert_allclose(float(aux["router_z"]),
                               z * cfg.moe.router_z_loss, rtol=1e-6)
    g, = torch.autograd.grad(aux["load_balance"] + aux["router_z"], w)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    assert not counts.requires_grad


@pytest.mark.parametrize("no_drop", [False, True], ids=["drops", "no_drop"])
def test_aux_gradient_reaches_the_router_as_the_reference(layer, no_drop):
    """The gradient of each auxiliary loss alone with respect to the
    router's w and b, from the whole layer (``moe_layer``), against
    ``jax.grad`` of the reference's ``moe_forward`` aux on the same layer
    and input: each term on its own, so that a term that does not reach the
    router (its probabilities or logits detached), or reaches it with
    another sign or weight, fails even where the cross-entropy's router
    gradient would hide it in the whole loss's. Both sides are f32 from
    the same bf16 input and the routing is exact on this input (the counts
    equal), so AUX_GRAD_TOL is f32 rounding, far under a term's size."""
    jcfg, cfg, jmoe, tmoe = layer
    xj, xt = _inputs(cfg, N_TOKENS, seed=4)
    ctx = dataclasses.replace(default_ctx(), moe_no_drop=no_drop)

    def jaux(router, name):
        return JM.moe_forward({**jmoe, "router": router}, jcfg,
                              xj.reshape(4, 16, -1), ctx,
                              with_aux=True)[1][name]

    w = tmoe["router"]["w"].clone().requires_grad_(True)
    b = tmoe["router"]["b"].clone().requires_grad_(True)
    _, aux = M.moe_layer({**tmoe, "router": {"w": w, "b": b}}, cfg,
                         xt.reshape(4, 16, -1), batch_invariant=False,
                         no_drop=no_drop, with_aux=True)
    k, e = cfg.moe.experts_per_token, cfg.moe.n_experts
    _, idx = M.route(xt, tmoe["router"], k, batch_invariant=False)
    counts = M.expert_counts(idx.reshape(-1), e)
    np.testing.assert_array_equal(counts.numpy(),
                                  _ref_plan(jmoe, xj, k, e, 1)[4])
    for name in ("load_balance", "router_z"):
        want = jax.jit(jax.grad(jaux), static_argnums=1)(jmoe["router"],
                                                         name)
        got = torch.autograd.grad(aux[name], (w, b), retain_graph=True)
        for g, leaf in zip(got, ("w", "b")):
            ref = np.asarray(want[leaf])
            assert np.abs(ref).max() > 0, (name, leaf)
            np.testing.assert_allclose(
                g.numpy(), ref, rtol=AUX_GRAD_TOL,
                atol=AUX_GRAD_TOL * np.abs(ref).max(), err_msg=(name, leaf))


def test_no_drop_path_keeps_its_bits(layer):
    """At inference capacity ``moe_layer`` is ``moe_forward`` (serving,
    the Fisher pass, the evaluations), bit for bit, and asking for the aux
    does not move the output; at a capacity factor big enough to drop
    nothing, the train capacity's placement computes the same output."""
    _, cfg, _, tmoe = layer
    _, xt = _inputs(cfg, 32, seed=5)
    x = xt.reshape(2, 16, -1)
    want = M.moe_forward(tmoe, cfg, x, batch_invariant=False)
    out, aux = M.moe_layer(tmoe, cfg, x, False, no_drop=True, with_aux=True)
    assert torch.equal(out, want) and sorted(aux) == ["load_balance",
                                                       "router_z"]
    out, aux = M.moe_layer(tmoe, cfg, x, False, no_drop=True)
    assert torch.equal(out, want) and aux == {}
    _, big = _with_cf(jconfigs.get_smoke_config(cfg.name[:-6]), cfg, 100.0)
    assert M.capacity(32, big) == 32
    out, _ = M.moe_layer(tmoe, big, x, False, no_drop=False)
    np.testing.assert_allclose(_f32(out), _f32(want), **ROW_TOL)


def test_backward_of_the_dispatch_repeats(layer):
    """The train capacity's forward adds through no atomics and its
    backward's scatters meet at most one nonzero a row: two backward
    passes give the same gradient bits (the card's bar is a bit-for-bit
    resume, ``chip_smoke.py``)."""
    _, cfg, _, tmoe = layer
    cfg = _with_cf(jconfigs.get_smoke_config(cfg.name[:-6]), cfg, 0.5)[1]
    _, xt = _inputs(cfg, N_TOKENS, seed=7)

    def grads():
        p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()})
             for k, v in tmoe.items()}
        x = xt.clone().requires_grad_(True)
        out, aux = M.moe_layer(p, cfg, x.reshape(4, 16, -1), False,
                               no_drop=False, with_aux=True)
        loss = out.float().square().sum() + aux["load_balance"] \
            + aux["router_z"]
        leaves = [x] + [t for v in p.values() for t in v.values()]
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)


def test_a_layer_with_no_expert_adds_zeros(layer):
    """ROADMAP C12: HQP may cut every expert of a layer; the masked layer
    (every expert zeroed and unroutable) computes zeros, so the compacted
    one, with a (d, 0) router, adds zeros on both routes and its aux are
    zeros; a layer with fewer experts than k routes to those it has."""
    _, cfg, _, tmoe = layer
    _, xt = _inputs(cfg, 8, seed=3)
    x = xt.reshape(2, 4, -1)
    empty = {"router": {"w": tmoe["router"]["w"][:, :0],
                        "b": tmoe["router"]["b"][:0]},
             **{name: {"w": tmoe[name]["w"][:0]} for name in M.EXPERT_KEYS}}
    for no_drop in (True, False):
        out, aux = M.moe_layer(empty, cfg, x, True, no_drop, with_aux=True)
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == x.shape
        assert not out.any() and not any(float(v) for v in aux.values())
    one = {"router": {"w": tmoe["router"]["w"][:, 2:3],
                      "b": tmoe["router"]["b"][2:3]},
           **{name: {"w": tmoe[name]["w"][2:3]} for name in M.EXPERT_KEYS}}
    gates, idx = M.route(xt, one["router"], cfg.moe.experts_per_token)
    assert idx.shape == (8, 1) and (idx == 0).all() and (gates == 1).all()
    assert torch.equal(M.moe_forward(one, cfg, x),
                       M.expert_ffn(xt[None], one).reshape(x.shape))
