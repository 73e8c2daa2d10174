"""The xLSTM family's HQP on the CPU, held against the JAX package on the
same weights, at period 2 with 2 groups (``DEEP``: layer g·2 + j is the
JAX tree's ``blocks[j][g]``): the ``mlstm_heads`` family (names, order,
sizes, members; the sLSTM layers unpruned), the Fisher pass, the ranking
and the masks; compaction with mLSTM heads cut, equal to the reference's
(the JAX artifact's shapes) and computing what the masked model
computes; artifacts both ways through the JAX package's checkpoint
module; and fault C11: a layer cut to no head at all, whose PTQ raises in
the reference and which the port compacts, quantizes and runs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_hybrid_common import jfisher, tfisher  # noqa: E402
from _torch_xlstm_common import (ARCH, DEEP, PERIOD8, _jover,  # noqa: E402,F401
                                 assert_close_system, assert_same_params,
                                 f32, make, np_tree, one_thread)
from repro import configs as jconfigs  # noqa: E402
from repro.compress import compress as jcompress  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.launch import checkpoint as jckpt  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.compress.artifact import compress  # noqa: E402
from repro_torch.core import pruning as pr  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.launch import checkpoint as ckpt  # noqa: E402
from repro_torch.models import lm, xlstm  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

# the compacted model against the masked one: the reference's own bound
# for this comparison (``tests/test_hqp.py::test_lm_mask_equals_compact``)
COMPACT = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(scope="module")
def deep():
    return make(**DEEP)


def _jpath(path, period):
    """A JAX member path ("__stack__", g, "blocks", j, ...) as the port's
    ("blocks", g·period + j, ...)."""
    return ("blocks", path[1] * period + path[3]) + tuple(path[4:])


@pytest.mark.parametrize("over", [{}, DEEP, PERIOD8, "full"],
                         ids=["smoke", "deep", "period8", "full"])
def test_prune_groups_equal_reference(over):
    """Names, kinds, sizes and order equal (the period position outer, the
    group inner), and each member is the reference's at the port's layer:
    one ``L{i}/mlstm_heads`` family an mLSTM layer, none for an sLSTM
    layer."""
    if over == "full":
        jcfg, cfg = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    else:
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                                   **_jover(over))
        cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    period = lm.pattern_period(cfg)
    jspecs = jsens.lm_prune_groups(jcfg)
    tspecs = sens.lm_prune_groups(cfg)
    assert [(s.name, s.kind, s.size) for s in tspecs] == [
        (s.name, s.kind, s.size) for s in jspecs]
    assert {s.kind for s in tspecs} == {"mlstm_head"}
    assert len(tspecs) == cfg.pattern.count("mlstm")
    for ts, js in zip(tspecs, jspecs):
        for attr in ("members_grad", "members_all"):
            want = [(_jpath(p, period), ax, blk, off)
                    for p, ax, blk, off in getattr(js, attr)]
            assert getattr(ts, attr) == want, ts.name


@pytest.fixture(scope="module")
def fisher(deep):
    """The reference's Fisher diagonal on the launcher's calibration batch,
    in both frameworks."""
    jsq = jfisher(deep)
    return jsq, from_jax_params(np_tree(jsq), device="cpu")


def _worst_unit(got, want):
    """Over the families, the largest |got - want| of a unit, as a
    fraction of its family's largest ``want``."""
    return max(float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


def test_fisher_ranks_and_masks_equal_reference(deep, fisher):
    """The port's own Fisher pass (autograd through the train route: the
    chunkwise mLSTM, the stepped sLSTM), unit by unit: each head's S lies
    nearer the reference's than the reference's own S moves between its
    two forms (its train route stepped at chunk 1 rather than chunkwise;
    the hybrid family's test bounds its units by the reference's movement
    under one bf16 step of noise in the embedding, which here moves them
    less than the port's gap and less than the reference's own two forms
    do; a family of two heads has no correlation to speak of). Given the
    reference's squared gradients the global ranking is exact, and the
    masks at half the heads are the reference's, leaf for leaf."""
    cfg, jcfg = deep["cfg"], deep["jcfg"]
    jsq, tsq_ref = fisher
    tspecs = sens.lm_prune_groups(cfg)
    jspecs = jsens.lm_prune_groups(jcfg)
    want = [np.asarray(jsens.group_sensitivity(jsq, js)) for js in jspecs]
    got = [sens.group_sensitivity(tfisher(deep), ts).numpy()
           for ts in tspecs]
    stepped = dict(deep, jcfg=dataclasses.replace(
        jcfg, xlstm=dataclasses.replace(jcfg.xlstm, chunk=1)))
    stepped.pop("jgrad", None)
    jsq_step = jfisher(stepped)
    forms = _worst_unit([np.asarray(jsens.group_sensitivity(jsq_step, js))
                         for js in jspecs], want)
    port = _worst_unit(got, want)
    print(f"worst head, of its family's largest S: port {port:.5f}, the "
          f"reference's stepped form against its chunkwise {forms:.5f}")
    assert port <= forms, (port, forms)
    jr = jpr.rank_units(jspecs, jsq)
    tr = pr.rank_units(tspecs, tsq_ref)
    np.testing.assert_array_equal(tr.spec_idx, jr.spec_idx)
    np.testing.assert_array_equal(tr.unit_idx, jr.unit_idx)
    n = tr.total // 2
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


def _cut_both(deep, drops):
    """The port's and the reference's masked and compacted trees of the
    deep model with ``drops`` cut by hand."""
    tr, n = _hand_ranking(pr.RankedUnits, sens.lm_prune_groups(deep["cfg"]),
                          drops)
    jr, _ = _hand_ranking(jpr.RankedUnits,
                          jsens.lm_prune_groups(deep["jcfg"]), drops)
    tm = pr.apply_prune_masks(deep["tp"], tr, n)
    jm = jpr.apply_prune_masks(deep["jp"], jr, n)
    return tm, pr.compact_params(tm, tr, n), jm, jpr.compact_params(jm, jr,
                                                                      n)


# one head cut in layer 0, none in layer 2: the compacted layers keep the
# least-pruned layer's two heads, layer 0 padding with its masked head
CUT = {"L0/mlstm_heads": [1]}
# one head cut in both groups: both compact to one head
CUT_BOTH = {"L0/mlstm_heads": [0], "L2/mlstm_heads": [1]}


@pytest.mark.parametrize("drops, heads", [(CUT, 2), (CUT_BOTH, 1)],
                         ids=["one-layer", "both-layers"])
def test_masked_equals_compacted_mlstm_heads(deep, drops, heads):
    """mLSTM heads cut by hand: the port's compacted tree, stacked, equals
    the reference's compacted tree leaf for leaf (each period position
    keeps its least-pruned layer's head count; the head width stays); the
    compacted model computes what the masked model computes (within the
    reference's own bound for this comparison), and the masked model
    computes what the reference's does (within the reference's rule
    between its own forms); the decode state is sized from
    the compacted ``in_proj`` and the decode route agrees too."""
    cfg, jcfg = deep["cfg"], deep["jcfg"]
    tm, tc, jm, jc = _cut_both(deep, drops)
    assert_same_params(tc, jc, 2)
    hd = xlstm.head_width(cfg)
    for i in (0, 2):
        ml = tc["blocks"][i]["mlstm"]
        assert ml["wq"].shape == (heads, hd, hd)
        assert ml["in_proj"]["w"].shape == (cfg.d_model, 2 * heads * hd)
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": torch.from_numpy(toks)}
    hm, hc = lm.forward(tm, cfg, batch), lm.forward(tc, cfg, batch)
    np.testing.assert_allclose(f32(hc), f32(hm), **COMPACT)
    hj = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t})[0])(
        jm, jnp.asarray(toks))
    assert_close_system(f32(hm), f32(hj))
    st = lm.init_decode_state(cfg, 1, 32, params=tc, device="cpu")
    assert st["caches"][0]["C"].shape == (1, heads, hd, hd)
    lc, _ = lm.decode_step(tc, cfg, st, batch["tokens"][:1],
                           route="prefill")
    lmk, _ = lm.decode_step(tm, cfg, lm.init_decode_state(
        cfg, 1, 32, params=tm, device="cpu"), batch["tokens"][:1],
        route="prefill")
    np.testing.assert_allclose(f32(lc), f32(lmk), **COMPACT)


def test_artifacts_both_ways(deep, tmp_path):
    """An INT8 artifact of the hand-cut model: in_proj, out_proj, up and
    down quantized, the per-head wq/wk/wv, the gates and the sLSTM's
    recurrent blocks kept in their precision, as the reference's PTQ does
    (its codes up to C1). The port's, saved in the JAX layout, loads into
    the reference with its stacked shapes and bits; the reference's,
    saved by the JAX package, loads into the port with the same bits; the
    port's loads back into the port."""
    cfg, jcfg = deep["cfg"], deep["jcfg"]
    _, tc, _, jc = _cut_both(deep, CUT_BOTH)
    art = compress(tc, cfg, log=lambda s: None)
    jart = jcompress(jc, jcfg, log=lambda s: None)
    ml = art.params["blocks"][0]["mlstm"]
    sl = art.params["blocks"][1]["slstm"]
    for lin in (ml["in_proj"], ml["out_proj"], sl["up"], sl["down"]):
        assert isinstance(lin, QuantizedLinear)
    assert ml["wq"].dtype == torch.bfloat16
    assert ml["w_f"]["w"].dtype == sl["rz"].dtype == torch.float32
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


def test_c11_a_layer_cut_to_no_head(deep):
    """Fault C11. Algorithm 1 may cut every head of an mLSTM layer (on
    the seed-0 smoke model the launcher's three steps do: 2 units, one a
    step). Cut both heads of both mLSTM layers by hand: the reference's
    PTQ of the compacted tree raises (an empty in_proj has no absmax);
    the port's compacts to an empty block (in_proj (d, 0), out_proj (0,
    d)), quantizes it, and its model runs: the block adds exact zeros, so
    the compacted model computes what the masked one does."""
    cfg, jcfg = deep["cfg"], deep["jcfg"]
    drops = {"L0/mlstm_heads": [0, 1], "L2/mlstm_heads": [0, 1]}
    tm, tc, _, jc = _cut_both(deep, drops)
    with pytest.raises(ValueError, match="zero-size"):
        jcompress(jc, jcfg, log=lambda s: None)
    ml = tc["blocks"][0]["mlstm"]
    assert ml["in_proj"]["w"].shape == (cfg.d_model, 0)
    assert ml["out_proj"]["w"].shape == (0, cfg.d_model)
    art = compress(tc, cfg, log=lambda s: None)
    q = art.params["blocks"][0]["mlstm"]["out_proj"]
    assert isinstance(q, QuantizedLinear) and q.w_q.shape == (0, cfg.d_model)
    toks = torch.from_numpy(
        np.random.RandomState(9).randint(0, cfg.vocab_size, (2, 12)))
    hm = lm.forward(tm, cfg, {"tokens": toks})
    hc = lm.forward(tc, cfg, {"tokens": toks})
    assert torch.equal(hc, hm)
    st = lm.init_decode_state(cfg, 2, 32, params=art.params, device="cpu")
    assert st["caches"][0]["C"].shape[1] == 0
    logits, _ = lm.decode_step(art.params, cfg, st, toks, route="prefill")
    assert torch.isfinite(logits).all()
