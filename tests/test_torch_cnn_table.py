"""The CNN experiment's table: the port's cost count of a forward
(``models.cnn.forward_cost``) and the modeled latency on ``H100_SXM``,
held against XLA's cost analysis of the JAX package's forward, and the
whole table through ``main`` at toy size, in the reference's layout.

Tolerances: the FLOP count within 1 % of XLA's, at width 0.25 and 1.0 and
on a compacted model; the byte count, a model of its own, 0.4 to 0.65 of
XLA's bytes accessed (measured 0.455 to 0.564).
"""
import ast
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_cnn_common import (ARCHS, WIDTH, cfgs, nets,  # noqa: E402
                               one_thread, to_jax)  # noqa: F401
from repro.models import cnn as jcnn  # noqa: E402
from repro.repro_exp import cnn_experiment as jexp  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import pruning as pr  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.repro_exp import cnn_experiment as exp  # noqa: E402
from repro_torch.roofline.hardware import H100_SXM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _xla_cost(jcfg, jv, batch=64):
    """XLA's cost analysis of the reference's eval forward of ``batch``
    images: its flops and bytes accessed."""
    x = jax.ShapeDtypeStruct((batch, 32, 32, 3), jnp.float32)
    ca = jax.jit(lambda v, xx: jcnn.cnn_apply(jcfg, v, xx)[0]).lower(
        jv, x).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"]), float(ca["bytes accessed"])


@functools.lru_cache(maxsize=None)
def _full_costs(arch, width):
    """Shapes only: the port's count and XLA's of the unpruned model (the
    reference's variables abstract, the port's on the meta device),
    compiled once for the tests of both."""
    cfg, jcfg = cfgs(arch, width)
    jv = jax.eval_shape(lambda: jcnn.cnn_init(jax.random.PRNGKey(0), jcfg))
    tv = cnn.cnn_init(cfg, torch.Generator().manual_seed(0), device="meta")
    return cnn.forward_cost(cfg, tv, 64, 32), _xla_cost(jcfg, jv)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("width", [WIDTH, 1.0])
def test_flop_count_within_one_percent_of_xla(arch, width):
    cost, (flops, _) = _full_costs(arch, width)
    assert cost["flops"] == pytest.approx(flops, rel=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("width", [WIDTH, 1.0])
def test_byte_count_beside_xla(arch, width):
    """The bytes are the port's own model, not XLA's: it fuses each BN,
    activation and residual add into the op that makes its input, where
    XLA's CPU fusions read and write more. The two were measured 0.455 to
    0.564 apart (the port's over XLA's ``bytes accessed``) at widths 0.25
    and 1.0; the test holds the ratio within 0.4 to 0.65, so that a byte
    model that drifts from the shapes (a term lost or counted twice)
    shows."""
    cost, (_, byts) = _full_costs(arch, width)
    assert 0.4 < cost["bytes"] / byts < 0.65


@pytest.mark.parametrize("arch", ARCHS)
def test_modeled_latency_of_a_compacted_model(nets, arch):
    """Counted from the compacted widths (P50 by magnitude, as in the
    experiment): within 1 % of XLA's count of the same compacted model in
    the reference; the modeled latency is the reference's formula on
    ``H100_SXM``."""
    n = nets[arch]
    mag = {"params": tree.map_(torch.square, n["tv"]["params"]),
           "stats": tree.map_(torch.zeros_like, n["tv"]["stats"])}
    r = pr.rank_units(sens.cnn_prune_groups(n["cfg"], n["tv"]), mag)
    tc = pr.compact_params(n["tv"], r, r.total // 2)
    cost = cnn.forward_cost(n["cfg"], tc, 64, 32)
    assert cost["flops"] == pytest.approx(
        _xla_cost(n["jcfg"], to_jax(tc))[0], rel=1e-2)
    for int8 in (False, True):
        byts = cost["bytes"] - (0.5 * pr.param_bytes(tc["params"])
                                if int8 else 0)
        peak = H100_SXM.peak_int8 if int8 else H100_SXM.peak_bf16
        assert exp.modeled_latency_ms(n["cfg"], tc, int8) == pytest.approx(
            1000 * max(cost["flops"] / peak, byts / H100_SXM.hbm_bw))


# ------------------------------------------------------------------ experiment
def _reference_table():
    """The keys of the reference's ``run_experiment`` table and its rows'
    method names, read from its source (running it would cost minutes)."""
    src = (ROOT / "src/repro/repro_exp/cnn_experiment.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "run_experiment")
    keys = methods = None
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "table"):
            keys = [k.value for k in node.value.keys]
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", "") == "add"):
            methods = (methods or []) + [node.args[0].value]
    return keys, methods


def test_main_writes_the_reference_table(tmp_path, monkeypatch):
    """``main`` at toy size (2 steps, width 0.0625) writes
    ``<out>/<arch>.json``: the reference's table keys, rows of the
    reference's fields in its order of methods, finite numbers, and the
    port's additions (eager latency, stage seconds, device). Its
    ``--act-method`` reaches the Q8 and HQP rows' calibrations."""
    keys, methods = _reference_table()
    calibrations = []
    calibrate = exp.calibrate_activations

    def spy(*args):
        calibrations.append(calibrate(*args))
        return calibrations[-1]
    monkeypatch.setattr(exp, "calibrate_activations", spy)
    exp.main(["--device", "cpu", "--arch", "resnet18", "--steps", "2",
              "--width", "0.0625", "--ntrain", "256", "--nval", "250",
              "--act-method", "percentile", "--out", str(tmp_path)])
    assert [q.method for q in calibrations] == ["percentile", "percentile"]
    for q in calibrations:
        assert all(q.scales[k] == st.scale("percentile")
                   for k, st in q.stats.items())
        assert any(q.scales[k] < st.scale("absmax")
                   for k, st in q.stats.items())
    table = json.loads((tmp_path / "resnet18.json").read_text())
    assert set(keys) <= set(table)
    assert set(table) - set(keys) == {"measured_eager_ms", "seconds",
                                      "device"}
    assert [r["method"] for r in table["rows"]] == methods
    fields = [f.name for f in dataclasses.fields(jexp.MethodResult)]
    for row in table["rows"]:
        assert list(row) == fields
        assert all(np.isfinite(row[k]) for k in fields
                   if k not in ("method", "compliant"))
    assert table["device"] == "cpu" and table["arch"] == "resnet18"
    assert table["rows"][1]["size_bytes"] < table["rows"][0]["size_bytes"]
    assert table["hqp_history"] and set(table["seconds"]) >= {
        "train", "fisher", "calibration", "latency", "algorithm1_evals"}
