"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), and each dispatch-plane check against a
body seeded with the fault it exists to catch.

A checker that cannot fail is decoration, so every check first fires on
a seeded fault; the real engines passing is asserted after. The AST
plane's rules that carry over give the reference's (rule, line, message)
on the reference test's own fixtures.
"""
import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import astlint, dispatch_checks as dc  # noqa: E402
from repro_torch.analysis import render  # noqa: E402
from repro_torch.analysis.invariants import (REGISTRY,  # noqa: E402
                                             declare_invariants)
from repro_torch.scripts import check_static  # noqa: E402
from repro_torch.telemetry.schema import PORT_ENGINE_STATS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_test_module():
    """The JAX package's static-analysis test module: its fixture snippets
    are the parity cases."""
    spec = importlib.util.spec_from_file_location(
        "_ref_static_analysis", ROOT / "tests" / "test_static_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_test_module()
_SERVING = REF._SERVING
_ENGINE = "src/repro/serving/engine.py"
_BENCH = "scripts/check_bench.py"

# (fixture, file it is linted as): the rules whose meaning carries over
PARITY = [
    ("_CLOCK_BAD", _SERVING), ("_CLOCK_GOOD", _SERVING),
    ("_CLOCK_DISABLED", _SERVING), ("_PUMP_BAD", _SERVING),
    ("_PUMP_GOOD", _SERVING), ("_BENCH_BAD", _BENCH),
    ("_BENCH_GOOD", _BENCH), ("_BENCH_BAD", "tests/test_foo.py"),
    ("_DUP_BAD", _ENGINE), ("_DUP_GOOD", _ENGINE),
]
SHARED_RULES = ("no-raw-clock", "pump-single-owner", "bench-gate-message",
                "duplicate-hot-path-helper")


def _triples(vs):
    return [(v.rule, v.line, v.message) for v in vs]


@pytest.mark.parametrize("fixture,filename", PARITY,
                         ids=[f"{f}@{p}" for f, p in PARITY])
def test_lint_parity_with_reference(fixture, filename):
    src = getattr(REF, fixture)
    ref = REF.astlint.lint_source(src, filename)
    ours = astlint.lint_source(src, filename)
    assert {v.rule for v in ref} <= set(SHARED_RULES)
    assert _triples(ours) == _triples(ref)
    assert render(ours) == REF.render(ref)


@pytest.mark.parametrize("rule", SHARED_RULES)
def test_shared_rule_parity_by_name(rule):
    """Each shared rule asked for by name gives the reference's findings on
    every fixture, whatever file it is linted as."""
    for fixture, filename in PARITY:
        src = getattr(REF, fixture)
        assert (_triples(astlint.lint_source(src, filename, rules=[rule]))
                == _triples(REF.astlint.lint_source(src, filename,
                                                    rules=[rule])))


def test_render_matches_reference():
    v = astlint.lint_source(REF._CLOCK_BAD + REF._DUP_BAD.replace(
        "import numpy as np", ""), _SERVING, rules=SHARED_RULES)
    r = REF.astlint.lint_source(REF._CLOCK_BAD + REF._DUP_BAD.replace(
        "import numpy as np", ""), _SERVING, rules=SHARED_RULES)
    assert len(v) == 3 and render(v) == REF.render(r)
    assert render([]) == REF.render([]) == "static checks: OK (0 violations)"


# ------------------------------------------------------------ stats-schema
# the reference's lint, read against the reference's schema, flags the
# port-only keys; every one of them is declared in the port's schema
REF_FLAGS = sorted([
    ("dispatch.py", "capture_s"), ("dispatch.py", "eager_dispatches"),
    ("dispatch.py", "graph_pool_bytes"), ("dispatch.py", "graph_replays"),
    ("dispatch.py", "graphs_captured"), ("engine.py", "kv_bytes"),
    ("engine.py", "spec_cycles"), ("engine.py", "spec_cycles")])


def test_reference_lint_flags_only_port_stats_keys():
    found = []
    for path in sorted((ROOT / "src/repro_torch/serving").glob("*.py")):
        src = path.read_text()
        lines = src.splitlines()
        for v in REF.astlint.lint_source(src, path.relative_to(ROOT)
                                         .as_posix()):
            assert v.rule == "stats-schema", str(v)
            key = v.message.split("'")[1]
            assert f'"{key}"' in lines[v.line - 1], str(v)
            found.append((path.name, key))
    assert sorted(found) == REF_FLAGS
    assert {k for _, k in found} <= set(PORT_ENGINE_STATS)


def test_port_lint_real_tree_clean():
    targets = astlint.default_targets(ROOT)
    assert ROOT / "src/repro_torch/serving/engine.py" in targets
    assert ROOT / "src/repro_torch/scripts/http_smoke.py" in targets
    v = astlint.lint_tree(ROOT)
    assert v == [], render(v)


def test_stats_schema_reads_the_port_schema():
    src = REF._STATS_BAD.replace('"submitted": 0',
                                 '"submitted": 0, "graph_replays": 0')
    v = astlint.lint_source(src, "src/repro_torch/serving/service.py")
    assert [x.rule for x in v] == ["stats-schema", "stats-schema"]
    assert "not_a_real_key" in v[0].message and "another_rogue" in v[1].message
    assert "repro_torch.telemetry.schema" in v[0].message
    assert astlint.lint_source(REF._STATS_GOOD,
                               "src/repro_torch/serving/service.py") == []


# --------------------------------------------------------- host-sync rule
_HOT_LAMBDA = """
def decode(self, x):
    self.graphs.run("decode", 64, lambda: x.item())
"""

_HOT_DEF = """
import numpy as np

def prefill(self, chunk):
    def body():
        n = int(chunk.sum())
        return np.asarray(chunk), n
    self.graphs.run("prefill", (16, 64), body)
"""

_HOT_CAPTURE = """
import torch

def capture(graph, x):
    with torch.cuda.graph(graph):
        y = float(x.sum())
"""

_HOT_GOOD = """
import numpy as np

def decode(self, x, out):
    def body():
        out.copy_(x * 2)
    self.graphs.run("decode", 64, body)
    return int(np.asarray(out.cpu()).sum())   # after the dispatch: fine

def other(x):
    return x.item()                           # not a dispatch body
"""

_ENGINE_PORT = "src/repro_torch/serving/engine.py"


@pytest.mark.parametrize("src,n", [(_HOT_LAMBDA, 1), (_HOT_DEF, 2),
                                   (_HOT_CAPTURE, 1)],
                         ids=["lambda", "nested-def", "cuda-graph-block"])
def test_host_sync_rule_fires_in_dispatch_bodies(src, n):
    v = astlint.lint_source(src, _ENGINE_PORT)
    assert [x.rule for x in v] == ["no-host-sync-in-hot-path"] * n, render(v)


def test_host_sync_rule_quiet_outside_bodies():
    assert astlint.lint_source(_HOT_GOOD, _ENGINE_PORT) == []
    disabled = _HOT_LAMBDA.replace(
        "x.item())", "x.item())  # repro-lint: disable=no-host-sync-in-hot-path")
    assert astlint.lint_source(disabled, _ENGINE_PORT) == []


# ---------------------------------------- seeded faults, one per check
@pytest.fixture(scope="module")
def engine():
    return dc.build_scenario(quantized_kv=False, paged=False, device="cpu")


def _check(eng, body):
    spec = eng.invariants["decode"]
    return dc.check_callable(body, spec, where="fixture", pools=[eng.pool],
                             protected=dc.protected_leaves(eng))


def test_arena_copy_fires_on_cloned_arena(engine):
    k = engine.pool["caches"][0]["k"]
    v = _check(engine, lambda: k.clone())
    assert [x.rule for x in v] == ["arena-copy"], render(v)
    # a slot-sized gather is allowed
    assert _check(engine, lambda: k[0:1].clone()) == []


def test_arena_copy_fires_on_replaced_leaf(engine):
    entry = engine.pool["caches"][1]
    k = entry["k"]
    other = torch.empty_like(k)      # made outside the body

    def swap():
        entry["k"] = other
    try:
        v = _check(engine, swap)
    finally:
        entry["k"] = k
    assert [x.rule for x in v] == ["arena-copy"], render(v)
    assert "replaced instead of updated in place" in v[0].message


def test_f32_roundtrip_fires_on_float_write(engine):
    k = engine.pool["caches"][0]["k"]
    v = _check(engine, lambda: k.copy_((k.float() * 1.0).to(k.dtype)))
    assert "f32-roundtrip" in {x.rule for x in v}, render(v)
    # the store in its own dtype passes
    assert _check(engine, lambda: k.mul_(1)) == []


def test_host_syncs_fires_on_item(engine):
    k = engine.pool["caches"][0]["k"]
    for body in (lambda: k[0, 0, 0, 0].item(), lambda: k[0, 0, 0].tolist(),
                 lambda: k[0, 0, 0].nonzero()):
        v = _check(engine, body)
        assert [x.rule for x in v] == ["host-syncs"], render(v)


def test_retrace_budget_fires_on_seeded_bound():
    """Drive the scripted workload, then declare the decode bound one under
    the keys it made: the check must fire; the real bound passes."""
    eng = dc.build_scenario(False, False, device="cpu")
    v = dc.check_retrace(eng, "bf16+contig")
    assert v == [], render(v)
    real = eng.invariants["decode"]
    n_keys = len(eng.graphs.keys["decode"])
    assert 1 <= n_keys <= real.max_lowerings
    eng.invariants["decode"] = dataclasses.replace(
        real, max_lowerings=n_keys - 1)
    v = dc.check_retrace(eng, "bf16+contig")
    assert [x.rule for x in v] == ["retrace-budget"], render(v)


# two nodes of a dump as ``CUDAGraph.debug_dump`` writes it on an H100
# (torch 2.11, CUDA 12.8): a 4 MiB device-to-device copy and a kernel
_DUMP = """digraph dot {
subgraph cluster_4 {
label="graph_4" graph[style="dashed"];
"graph_4_node_0"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {0 (topoId: 3) | 0x00000000099BDA68}}
| {kind | DtoD (DEVICE to DEVICE)}
| {{srcPtr | dstPtr} | {pitch | ptr | xsize | ysize | pitch | ptr | xsize | ysize} | {0 | 0x00007F3641000000 | 0 | 0 | 0 | 0x00007F3641400000 | 0 | 0}}
| {{srcPos | {{x | 0} | {y | 0} | {z | 0}}} | {dstPos | {{x | 0} | {y | 0} | {z | 0}}} | {Extent | {{Width | 4194304} | {Height | 1} | {Depth | 1}}}}
}"];

"graph_4_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 1) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEESt5arrayIPcLm1EEEEviT0_T1_\\<\\<\\<64,128,0\\>\\>\\>}
| {cooperative | 0}
}"];
}
}
"""


def test_graph_dump_parser_reads_copy_nodes():
    assert dc.graph_copy_nodes(_DUMP) == [("MEMCPY", 4194304)]
    memset = _DUMP.replace("MEMCPY", "MEMSET").replace(
        "{Extent | {{Width | 4194304} | {Height | 1} | {Depth | 1}}}",
        "{{value | elementSize | width | height} | {0 | 4 | 1024 | 2}}")
    assert dc.graph_copy_nodes(memset) == [("MEMSET", 8192)]
    blind = _DUMP.replace("{Width | 4194304} | ", "")
    with pytest.raises(RuntimeError, match="no size"):
        dc.graph_copy_nodes(blind)
    leaf = torch.zeros(1 << 20, dtype=torch.float32)
    v = dc.graph_violations(dc.graph_copy_nodes(_DUMP), "fixture", [leaf])
    assert [x.rule for x in v] == ["arena-copy"]
    assert dc.graph_violations(dc.graph_copy_nodes(_DUMP), "fixture",
                               [leaf[:1024]]) == []


# ------------------------------------------------------- real engines
SCENARIOS = [(False, False, False), (False, True, False),
             (True, False, False), (True, True, False), (True, False, True)]


@pytest.mark.parametrize("quantized_kv,paged,spec", SCENARIOS,
                         ids=[dc.scenario_name(*s) for s in SCENARIOS])
def test_real_engine_hot_paths_pass(quantized_kv, paged, spec):
    eng = dc.build_scenario(quantized_kv, paged, speculative=spec,
                            device="cpu")
    names = set(dc.engine_hot_paths(eng))
    assert names == ({"engine.reset"} | ({"engine.copy_page"} if paged
                                         else set())
                     | ({"engine.spec", "engine.spec_prefill"} if spec
                        else {"engine.decode", "engine.prefill"}))
    v = dc.check_engine(eng, dc.scenario_name(quantized_kv, paged, spec))
    assert v == [], render(v)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_real_engine_retrace_within_bound(paged):
    eng = dc.build_scenario(False, paged, device="cpu")
    v = dc.check_retrace(eng, dc.scenario_name(False, paged))
    assert v == [], render(v)
    assert all(len(keys) >= 1 for keys in eng.graphs.keys.values())


# -------------------------------------------------------------- registry
@pytest.fixture(scope="module")
def reference_registry():
    """The JAX package's declarations, from its paged speculative engine
    (which declares all six) at the same smoke size."""
    from repro.analysis import hlo_checks
    from repro.analysis.invariants import REGISTRY as REF_REGISTRY
    hlo_checks.build_scenario(True, True, speculative=True)
    return dict(REF_REGISTRY)


NAMES = ("engine.reset", "engine.prefill", "engine.decode",
         "engine.spec_prefill", "engine.copy_page", "engine.spec")


def _port_registry(paged: bool):
    out = {}
    for spec in (False, True):
        eng = dc.build_scenario(False, paged, speculative=spec, device="cpu")
        out.update({f"engine.{k}": s for k, s in eng.invariants.items()})
    out.update({n: REGISTRY[n] for n in ("engine.reset", "engine.copy_page")})
    return out


def test_registry_matches_reference(reference_registry):
    ours = _port_registry(paged=True)
    assert set(NAMES) <= set(REGISTRY) and set(ours) == set(NAMES)
    for name in NAMES:
        ref, port = reference_registry[name], ours[name]
        assert port.host_syncs == ref.host_syncs == 1, name
        assert port.forbid_f32_roundtrip_on == ref.forbid_f32_roundtrip_on
        if name == "engine.copy_page":
            # the port copies one pool a call; the engine calls it for the
            # verifier's pool, then the drafter's
            assert ref.donated == ("pool", "dpool")
            assert port.donated == ("pool",)
        else:
            assert port.donated == ref.donated, name


def test_registry_bounds_name_the_differences(reference_registry):
    """max_lowerings: the port's bound is its GraphCache bound. Decode
    agrees with the reference; the rest differ, by name."""
    n_windows, chunk, n_slots = 64 // 16, 16, 2
    ref = {n: reference_registry[n].max_lowerings for n in NAMES}
    assert ref == {"engine.reset": 2, "engine.prefill": n_windows * chunk,
                   "engine.decode": n_windows,
                   "engine.spec_prefill": n_windows * chunk,
                   "engine.copy_page": None, "engine.spec": None}
    for paged in (False, True):
        ours = {n: s.max_lowerings for n, s in _port_registry(paged).items()}
        per_slot = 1 if paged else n_slots
        assert ours == {
            # admission's reset and copy-on-write run eagerly: no graph
            "engine.reset": None, "engine.copy_page": None,
            "engine.decode": n_windows,
            # contiguous prefill is keyed by the slot too (its cache is a
            # view at the slot's offset)
            "engine.prefill": n_windows * chunk * per_slot,
            "engine.spec_prefill": n_windows * chunk * per_slot,
            # one graph per window and plan (k_eff, cycles_eff): k 4 x 1
            "engine.spec": n_windows * 4}, paged


def test_declare_invariants_rejects_unknown_arg():
    with pytest.raises(ValueError):
        declare_invariants("fixture.bad", donated=("nope",))(
            lambda pool: pool)


# ------------------------------------------------------------------ gate
@pytest.mark.parametrize("plane", ["ast", "all"])
def test_check_static_gate(plane, capsys):
    assert check_static.main(["--plane", plane, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "static checks: OK (0 violations)" in out
    assert ("[dispatch] scenario int8+contig+spec" in out) == (plane == "all")


def test_check_static_gate_fails_on_a_violation(monkeypatch, capsys):
    bad = [dc.Violation("dispatch", "host-syncs", "engine.decode[x]", "m")]
    monkeypatch.setattr(dc, "run_dispatch_plane",
                        lambda device=None, log=print: bad)
    assert check_static.main(["--plane", "dispatch", "--device", "cpu"]) == 1
    assert "static checks: 1 violation(s)" in capsys.readouterr().out


def test_dispatch_plane_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dc.build_scenario(False, False)
