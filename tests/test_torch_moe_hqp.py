"""The expert pruning family on the CPU, held against the JAX package on
the phi3.5-moe and arctic smoke configs, same weights: its names, sizes and
members, its Fisher sensitivities and global ranking, its masks (a masked
expert's router bias -1e9), fault C7 and its repair, an artifact of the
port's own launcher (Fisher, Algorithm 1, compaction, PTQ) loaded and
served by the JAX package, and the training launchers taking an MoE
config. Tolerances: ``_torch_moe_common``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_moe_common import (HIDDEN, S_FRAC,  # noqa: E402,F401
                               assert_close_moe, assert_greedy,
                               assert_same_params, base, f32, jforward,
                               np_tree, one_thread)
from repro import configs as jconfigs  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.launch import checkpoint as jckpt  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.core import pruning as pr  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.launch import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402,E501
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402


@pytest.fixture(scope="module")
def fisher(base):
    """The reference's Fisher diagonal on the calibration batch, in both
    frameworks."""
    jcfg, ctx = base["jcfg"], base["ctx"]
    grad = jax.jit(jax.grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b, ctx, with_aux=False)[0]))
    jsq, _ = jsens.fisher_diag(grad, base["jp"], [base["jb"]])
    return jsq, from_jax_params(np_tree(jsq), device="cpu")


def _experts(specs):
    return [s for s in specs if s.kind == "expert"]


def _expert_ranking(cls, specs, drops):
    """A ``cls`` ranking over the expert families alone that drops, in
    family i, the experts ``drops[i]``."""
    spec_idx = [i for i, d in enumerate(drops) for _ in d]
    unit_idx = [u for d in drops for u in d]
    return cls(specs, np.asarray(spec_idx), np.asarray(unit_idx),
               np.zeros(len(unit_idx), np.float32))


def test_prune_groups_equal_reference(base):
    """Names, kinds, sizes and order equal, at the smoke and the published
    widths; each member is the JAX member with ("__stack__", g, "blocks",
    0) read as ("blocks", g); the expert family adds the router bias to
    ``members_all`` (the C7 repair), and an MoE layer has no FFN family
    (arctic's residual MLP is not pruned)."""
    jspecs = jsens.lm_prune_groups(base["jcfg"])
    tspecs = sens.lm_prune_groups(base["cfg"])
    assert [(s.name, s.kind, s.size) for s in tspecs] == [
        (s.name, s.kind, s.size) for s in jspecs]
    assert {s.kind for s in tspecs} == {"kv_head", "expert"}
    for ts, js in zip(tspecs, jspecs):
        for attr in ("members_grad", "members_all"):
            want = [(("blocks", p[1]) + p[4:], ax, blk, off)
                    for p, ax, blk, off in getattr(js, attr)]
            if attr == "members_all" and ts.kind == "expert":
                want.append((("blocks", js.members_all[0][0][1], "moe",
                              "router", "b"), 0, 1, 0))
            assert getattr(ts, attr) == want, ts.name
    arch = base["cfg"].name.removesuffix("-smoke")
    full_t = sens.lm_prune_groups(configs.get_config(arch))
    full_j = jsens.lm_prune_groups(jconfigs.get_config(arch))
    assert [(s.name, s.size) for s in full_t] == [(s.name, s.size)
                                                  for s in full_j]


def test_fisher_sensitivities_and_ranks_match_reference(base, fisher):
    """The port's own Fisher pass (autograd through the train route's
    dispatch) gives each unit's S within S_FRAC of the reference's; given
    the reference's squared gradients the global ranking is exact."""
    jsq, tsq_ref = fisher
    tsq, _ = sens.fisher_diag(
        sens.loss_grad_fn(lambda p, b: lm.loss_fn(p, base["cfg"], b)),
        base["tp"], [base["tb"]])
    tspecs = sens.lm_prune_groups(base["cfg"])
    jspecs = jsens.lm_prune_groups(base["jcfg"])
    for ts, js in zip(tspecs, jspecs):
        want = np.asarray(jsens.group_sensitivity(jsq, js))
        got = sens.group_sensitivity(tsq, ts).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=S_FRAC * np.abs(want).max(),
                                   err_msg=ts.name)
    jr = jpr.rank_units(jspecs, jsq)
    tr = pr.rank_units(tspecs, tsq_ref)
    np.testing.assert_array_equal(tr.spec_idx, jr.spec_idx)
    np.testing.assert_array_equal(tr.unit_idx, jr.unit_idx)
    np.testing.assert_allclose(tr.s_values, jr.s_values, rtol=1e-5)


@pytest.mark.parametrize("drops", [((1,), ()), ((0, 2), (3,))],
                         ids=["one-layer", "every-layer"])
def test_expert_masks_equal_reference(base, drops):
    """Masking zeroes an expert's gate/up/down and router column and sets
    its router bias to -1e9, as the reference does: every masked leaf
    equal; the input params keep their values."""
    tspecs = _experts(sens.lm_prune_groups(base["cfg"]))
    jspecs = _experts(jsens.lm_prune_groups(base["jcfg"]))
    n = sum(len(d) for d in drops)
    tm = pr.apply_prune_masks(
        base["tp"], _expert_ranking(pr.RankedUnits, tspecs, drops), n)
    jm = jpr.apply_prune_masks(
        base["jp"], _expert_ranking(jpr.RankedUnits, jspecs, drops), n)
    assert_same_params(tm, jm)
    for g, d in enumerate(drops):
        moe = tm["blocks"][g]["moe"]
        assert all(moe["router"]["b"][u] == -1e9 for u in d)
        assert (moe["up"]["w"][list(d)] == 0).all()
        assert (moe["router"]["w"][:, list(d)] == 0).all()
    assert_same_params(base["tp"], base["jp"])


def test_c7_compacted_equals_reference_masked(base):
    """Fault C7 and its repair. With an expert dropped from every layer the
    reference's ``compact_params`` shrinks the router's columns but not its
    bias, and its compacted forward raises; the port compacts the bias
    with the columns, and its compacted model computes what the reference's
    masked model (and the port's own) computes."""
    drops = ((1,), (1,))
    tspecs = _experts(sens.lm_prune_groups(base["cfg"]))
    jspecs = _experts(jsens.lm_prune_groups(base["jcfg"]))
    tr = _expert_ranking(pr.RankedUnits, tspecs, drops)
    jr = _expert_ranking(jpr.RankedUnits, jspecs, drops)
    jm = jpr.apply_prune_masks(base["jp"], jr, 2)
    jc = jpr.compact_params(jm, jr, 2)
    e = base["cfg"].moe.n_experts
    assert jc["blocks"][0]["moe"]["router"]["w"].shape[-1] == e - 1
    assert jc["blocks"][0]["moe"]["router"]["b"].shape[-1] == e
    with pytest.raises(ValueError, match="broadcast"):
        jforward(jc, base["jcfg"], base["jb"]["tokens"])

    tm = pr.apply_prune_masks(base["tp"], tr, 2)
    tc = pr.compact_params(tm, tr, 2)
    for blk in tc["blocks"]:
        moe = blk["moe"]
        assert moe["router"]["w"].shape[-1] == e - 1
        assert moe["router"]["b"].shape == (e - 1,)
        assert moe["gate"]["w"].shape[0] == e - 1
        assert (moe["router"]["b"] == 0).all()
    assert pr.param_bytes(tc) < pr.param_bytes(base["tp"])
    hj = jforward(jm, base["jcfg"], base["jb"]["tokens"])
    for params in (tc, tm):
        assert_close_moe(f32(lm.forward(params, base["cfg"], base["tb"])),
                         f32(hj), **HIDDEN)


def test_port_artifact_loads_into_the_reference(base, tmp_path):
    """The port's own launcher artifact (Fisher, three conditional steps,
    compaction, PTQ), saved in the JAX layout: the reference loads it with
    the stacked shapes, and serves it. Its prefill's greedy tokens are the
    port's: the reference quantizes activations under jit through a
    multiply by fl(1/127) (ROADMAP C1), so a code sits a step off the
    port's here and there, and INT8 routing may then flip a near tie."""
    cfg, jcfg = base["cfg"], base["jcfg"]
    art = serve.build_artifact(lm.init_params(cfg, seed=0, device="cpu"),
                               cfg, prune_steps=3, log=lambda s: None)
    path = ckpt.save_artifact(str(tmp_path / "artifact"), art)
    jart = jckpt.load_artifact(path)
    assert jart.manifest.asdict() == art.manifest.asdict()
    g = jart.params["blocks"][0]["moe"]["gate"]
    t = art.params["blocks"][0]["moe"]["gate"]
    assert g.w_q.shape == (cfg.n_layers, *t.w_q.shape)
    assert g.scale.shape == (cfg.n_layers, *t.scale.shape)
    assert_same_params(art.params, jart.params)
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 9))
    ctx = dataclasses.replace(base["ctx"], quantized_kv=True)
    jl, _ = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))(
        jart.params, jlm.init_decode_state(jcfg, 2, 16, ctx,
                                           params=jart.params),
        jnp.asarray(prompt, jnp.int32))
    tl, _ = lm.decode_step(art.params, cfg, lm.init_decode_state(
        cfg, 2, 16, params=art.params, quantized_kv=True, device="cpu"),
        torch.from_numpy(prompt), route="prefill")
    a = np.asarray(jl[:, -1])[:, :cfg.vocab_size]
    assert np.isfinite(a).all()
    assert_greedy(tl[:, 0].numpy()[:, :cfg.vocab_size], a)


def _launch_main(arch):
    """Two steps of the train launcher on the smoke config -> its stdout's
    step lines are checked by the caller; returns the params."""
    return train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--eval-every", "0"])


def _one_step(arch):
    """One step of ``make_train_step`` at the launcher's drops -> the
    metrics."""
    cfg = configs.get_smoke_config(arch)
    ocfg = AdamWConfig(lr=1e-3)
    params = lm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 17)))
    return make_train_step(cfg, ocfg, moe_no_drop=False)(
        params, adamw_init(params, ocfg), {"tokens": tokens})[2]


@pytest.mark.parametrize("launcher", ["train.main", "make_train_step"])
def test_training_launchers_refuse_moe(launcher, capsys):
    """MoE training is ported (capacity-factor drops, the load-balance and
    router-z losses; the name is this test's from when the launchers
    refused it): the train launcher, and ``make_train_step``, through which
    it and the quickstart train, take an MoE config, take finite steps and
    report the auxiliary losses."""
    arch = "phi3.5-moe-42b-a6.6b"
    if launcher == "train.main":
        params = _launch_main(arch)
        assert all(torch.isfinite(t.float()).all()
                   for t in tree.leaves(params))
        out = capsys.readouterr().out
        assert "aux/load_balance=" in out and "aux/router_z=" in out
        assert "[train] done" in out
        return
    m = _one_step(arch)
    assert sorted(m) == ["aux/load_balance", "aux/router_z", "loss"]
    assert all(np.isfinite(float(v)) for v in m.values())
