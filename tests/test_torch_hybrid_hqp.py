"""The hybrid family's HQP on the CPU, held against the JAX package on the
same weights, at period 2 with 2 groups (``DEEP``: layer g·2 + j is the
JAX tree's ``blocks[j][g]``): the ``mamba_cols``, ``ffn``, ``kv_heads`` and
``experts`` families (names, order, sizes, members), the Fisher pass, the
ranking and the masks; compaction with Mamba channels cut, equal to the
reference's (the JAX artifact's shapes) and computing what the masked
model computes; and artifacts both ways through the JAX package's
checkpoint module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from _torch_hybrid_common import (ARCH, DEEP, HIDDEN,  # noqa: E402,F401
                                  assert_close_moe, assert_same_params, f32,
                                  jfisher, jforward, make, np_tree,
                                  one_thread, tfisher)
from repro import configs as jconfigs  # noqa: E402
from repro.compress import compress as jcompress  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.launch import checkpoint as jckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.compress.artifact import compress  # noqa: E402
from repro_torch.core import pruning as pr  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.launch import checkpoint as ckpt  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

S_CORR, S_MASS = 0.99, 5e-2


@pytest.fixture(scope="module")
def deep():
    return make(**DEEP)


# ------------------------------------------------------------------ HQP
def _jpath(path, period):
    """A JAX member path ("__stack__", g, "blocks", j, ...) as the port's
    ("blocks", g·period + j, ...)."""
    return ("blocks", path[1] * period + path[3]) + tuple(path[4:])


@pytest.mark.parametrize("over", [{}, DEEP], ids=["smoke", "deep"])
def test_prune_groups_equal_reference(over):
    """Names, kinds, sizes and order equal (the period position outer, the
    group inner); each member is the reference's at the port's layer; the
    expert family adds the router bias (C7's repair). At the published 72
    layers the names and sizes equal too."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    period = lm.pattern_period(cfg)
    jspecs = jsens.lm_prune_groups(jcfg)
    tspecs = sens.lm_prune_groups(cfg)
    assert [(s.name, s.kind, s.size) for s in tspecs] == [
        (s.name, s.kind, s.size) for s in jspecs]
    assert {s.kind for s in tspecs} == {"kv_head", "ffn_col", "expert",
                                        "mamba_col"}
    for ts, js in zip(tspecs, jspecs):
        for attr in ("members_grad", "members_all"):
            want = [(_jpath(p, period), ax, blk, off)
                    for p, ax, blk, off in getattr(js, attr)]
            if attr == "members_all" and ts.kind == "expert":
                want.append((want[0][0][:2] + ("moe", "router", "b"), 0, 1,
                             0))
            assert getattr(ts, attr) == want, ts.name
    full_t = sens.lm_prune_groups(configs.get_config(ARCH))
    full_j = jsens.lm_prune_groups(jconfigs.get_config(ARCH))
    assert [(s.name, s.size) for s in full_t] == [(s.name, s.size)
                                                  for s in full_j]


@pytest.fixture(scope="module")
def fisher(deep):
    """The reference's Fisher diagonal on the launcher's calibration batch,
    in both frameworks."""
    jsq = jfisher(deep)
    return jsq, from_jax_params(np_tree(jsq), device="cpu")


def test_fisher_ranks_and_masks_equal_reference(deep, fisher):
    """The port's own Fisher pass (autograd through the train route, the
    Mamba recurrence and the MoE layers included) gives each family's S
    the reference's shape and mass: a correlation over the units of at
    least S_CORR, and a total within S_MASS. Unit by unit the two sit
    further apart than on the dense configs; the next test bounds each
    unit and says why (``test_torch_hybrid_fisher``). Given the reference's squared gradients the global
    ranking is exact, and the masks at a third of the units are the
    reference's, leaf for leaf."""
    cfg, jcfg = deep["cfg"], deep["jcfg"]
    jsq, tsq_ref = fisher
    tsq = tfisher(deep)
    tspecs = sens.lm_prune_groups(cfg)
    jspecs = jsens.lm_prune_groups(jcfg)
    for ts, js in zip(tspecs, jspecs):
        want = np.asarray(jsens.group_sensitivity(jsq, js))
        got = sens.group_sensitivity(tsq, ts).numpy()
        assert np.corrcoef(got, want)[0, 1] >= S_CORR, ts.name
        assert abs(got.sum() / want.sum() - 1) <= S_MASS, ts.name
    jr = jpr.rank_units(jspecs, jsq)
    tr = pr.rank_units(tspecs, tsq_ref)
    np.testing.assert_array_equal(tr.spec_idx, jr.spec_idx)
    np.testing.assert_array_equal(tr.unit_idx, jr.unit_idx)
    n = tr.total // 3
    assert_same_params(pr.apply_prune_masks(deep["tp"], tr, n),
                       jpr.apply_prune_masks(deep["jp"], jr, n), 2)


def _hand_ranking(cls, specs, drops):
    """A ``cls`` ranking that drops ``drops[name]`` (unit indices) in the
    family of that name."""
    spec_idx, unit_idx = [], []
    for i, s in enumerate(specs):
        for u in drops.get(s.name, ()):
            spec_idx.append(i)
            unit_idx.append(u)
    return cls(specs, np.asarray(spec_idx), np.asarray(unit_idx),
               np.zeros(len(unit_idx), np.float32)), len(unit_idx)


# mamba channels (d_in 128) and FFN columns (96) cut in both groups, more
# in one layer than the other: the compacted layers pad to one width
CUT = {"L0/mamba_cols": list(range(0, 128, 4)),
       "L2/mamba_cols": list(range(1, 128, 5)),
       "L0/ffn": [3, 7, 50], "L2/ffn": [1, 2, 3, 4, 5],
       "L1/kv_heads": [1]}


def test_masked_equals_compacted_mamba_cols(deep):
    """Mamba channels cut by hand in both groups (and FFN columns, a KV
    head): the port's compacted tree, stacked, equals the reference's
    compacted tree leaf for leaf (the JAX artifact's shapes: each period
    position pads to its least-pruned layer); the compacted model computes
    what the masked model computes, and what the reference's masked model
    computes; its decode state is sized from the compacted ``conv_w``."""
    cfg, jcfg = deep["cfg"], deep["jcfg"]
    tspecs = sens.lm_prune_groups(cfg)
    jspecs = jsens.lm_prune_groups(jcfg)
    tr, n = _hand_ranking(pr.RankedUnits, tspecs, CUT)
    jr, _ = _hand_ranking(jpr.RankedUnits, jspecs, CUT)
    tm = pr.apply_prune_masks(deep["tp"], tr, n)
    tc = pr.compact_params(tm, tr, n)
    jm = jpr.apply_prune_masks(deep["jp"], jr, n)
    jc = jpr.compact_params(jm, jr, n)
    assert_same_params(tc, jc, 2)
    d_in = 128 - min(len(CUT["L0/mamba_cols"]), len(CUT["L2/mamba_cols"]))
    assert tc["blocks"][0]["mamba"]["conv_w"].shape == (4, d_in)
    assert tc["blocks"][2]["mamba"]["in_proj"]["w"].shape == (64, 2 * d_in)
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": torch.from_numpy(toks)}
    hm, hc = lm.forward(tm, cfg, batch), lm.forward(tc, cfg, batch)
    np.testing.assert_allclose(f32(hc), f32(hm), **HIDDEN)
    assert_close_moe(f32(hm), f32(jforward(jm, jcfg, toks)))
    st = lm.init_decode_state(cfg, 1, 32, params=tc, device="cpu")
    assert st["caches"][0]["h"].shape == (1, d_in, cfg.ssm.d_state)
    assert st["caches"][2]["conv"].shape == (1, cfg.ssm.d_conv - 1, d_in)
    lc, _ = lm.decode_step(tc, cfg, st, batch["tokens"][:1],
                           route="prefill")
    lmk, _ = lm.decode_step(tm, cfg, lm.init_decode_state(
        cfg, 1, 32, params=tm, device="cpu"), batch["tokens"][:1],
        route="prefill")
    np.testing.assert_allclose(f32(lc), f32(lmk), rtol=0, atol=5e-2)


def test_artifacts_both_ways(deep, tmp_path):
    """An INT8 artifact of the hand-cut model: in_proj and out_proj
    quantized, x_proj and dt_proj kept FP, as the reference's PTQ does
    (its codes up to C1). The port's, saved in the JAX layout, loads into
    the reference with its stacked shapes and bits; the reference's, saved
    by the JAX package, loads into the port with the same bits; the
    port's loads back into the port."""
    cfg, jcfg = deep["cfg"], deep["jcfg"]
    tr, n = _hand_ranking(pr.RankedUnits, sens.lm_prune_groups(cfg), CUT)
    jr, _ = _hand_ranking(jpr.RankedUnits, jsens.lm_prune_groups(jcfg), CUT)
    tc = pr.compact_params(pr.apply_prune_masks(deep["tp"], tr, n), tr, n)
    jc = jpr.compact_params(jpr.apply_prune_masks(deep["jp"], jr, n), jr, n)
    art = compress(tc, cfg, log=lambda s: None)
    jart = jcompress(jc, jcfg, log=lambda s: None)
    mamba = art.params["blocks"][0]["mamba"]
    assert isinstance(mamba["in_proj"], QuantizedLinear)
    assert isinstance(mamba["out_proj"], QuantizedLinear)
    assert not isinstance(mamba["x_proj"], QuantizedLinear)
    assert mamba["dt_proj"]["w"].dtype == torch.float32
    assert_same_params(art.params, jart.params, 2, c1=True)
    path = ckpt.save_artifact(str(tmp_path / "port"), art)
    loaded_j = jckpt.load_artifact(path)
    assert_same_params(art.params, loaded_j.params, 2)
    assert loaded_j.manifest.asdict() == art.manifest.asdict()
    jpath = jckpt.save_artifact(str(tmp_path / "jax"), jart)
    loaded_t = ckpt.load_artifact(jpath, device="cpu")
    assert_same_params(loaded_t.params, jart.params, 2)
    again = ckpt.load_artifact(path, device="cpu")
    assert_same_params(again.params, loaded_j.params, 2)
