"""The port's telemetry plane (``repro_torch.telemetry``) against the JAX
package's (``repro.telemetry``), exactly: the same schema constants, the
same exposition text for the same observations (and each package's parser
reads the other's), the same histogram arithmetic, the same traces from the
same span lifecycle; and every stats key the port's engine and service
write is declared."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import telemetry as rtel  # noqa: E402
from repro_torch import configs, telemetry as ptel  # noqa: E402
from repro_torch.compress import quantize_lm_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (Engine, Request, SchedulerConfig,  # noqa: E402
                                 Service, ServiceConfig)

ARCH = "qwen3-0.6b"
PACKAGES = {"reference": rtel, "port": ptel}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers would
    oversubscribe the cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- schema
@pytest.mark.parametrize("name", [
    "PHASE_BUCKETS_S", "LATENCY_BUCKETS_S", "PHASES", "SPAN_NAMES",
    "INSTANT_NAMES", "TERMINAL_REASONS", "PHASE_HISTOGRAM",
    "TTFT_HISTOGRAM", "LATENCY_HISTOGRAM", "ENGINE_PREFIX",
    "SERVICE_PREFIX", "SERVICE_STATS"])
def test_schema_constants_equal_the_reference(name):
    assert getattr(ptel.schema, name) == getattr(rtel.schema, name)


def test_engine_stats_extend_the_reference_letter_for_letter():
    """Every reference engine stat is declared as it is there; the port's
    own keys are only added, never renamed; every reference family name is
    among the port's."""
    assert ptel.schema.REFERENCE_ENGINE_STATS == rtel.schema.ENGINE_STATS
    for key, decl in rtel.schema.ENGINE_STATS.items():
        assert ptel.schema.ENGINE_STATS[key] == decl
    assert not set(ptel.schema.PORT_ENGINE_STATS) & set(
        rtel.schema.ENGINE_STATS)
    assert set(rtel.schema.metric_names()) <= set(
        ptel.schema.metric_names())
    assert ptel.schema.DECLARED_STAT_KEYS >= rtel.schema.DECLARED_STAT_KEYS


@pytest.mark.parametrize("spec", [(1e-6, 10.0, 4), (1e-3, 100.0, 4),
                                  (1e-3, 1.0, 2), (0.5, 5e4, 7)])
def test_log_buckets_equal(spec):
    assert ptel.schema.log_buckets(*spec) == rtel.schema.log_buckets(*spec)


def test_log_buckets_refuse_alike():
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError):
            pkg.schema.log_buckets(1.0, 0.1)


# ---------------------------------------------------------------- exposition
def _observations(seed):
    rng = np.random.RandomState(seed)
    return [float(v) for v in 10.0 ** rng.uniform(-7, 2.5, size=300)]


def _fill(pkg, seed):
    """One registry per package fed the same observations, counters,
    gauges (a nasty label included) and an adopted stats dict."""
    reg = pkg.MetricsRegistry()
    sch = pkg.schema
    reg.counter("t_total", "total things").inc(7)
    reg.gauge("t_jobs", "live jobs").set(3.25)
    reg.gauge("g_esc", "escaped", tag='back\\slash "quoted"\nnewline').set(1)
    stats = {"submitted": 41, "shed": 2, "queue_peak": 5}
    reg.register_stats(sch.SERVICE_PREFIX, stats, sch.SERVICE_STATS)
    stats["submitted"] += 1                     # read live at render
    obs = _observations(seed)
    for phase in sch.PHASES:
        h = reg.histogram(sch.PHASE_HISTOGRAM, "phase", phase=phase,
                          buckets=sch.PHASE_BUCKETS_S)
        for v in obs[:50 + 10 * len(phase)]:
            h.observe(v)
    lat = reg.histogram(sch.LATENCY_HISTOGRAM, "latency",
                        buckets=sch.LATENCY_BUCKETS_S)
    for v in obs:
        lat.observe(v)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_observations_render_the_same_exposition(seed):
    ref = _fill(rtel, seed).render()
    port = _fill(ptel, seed).render()
    assert port == ref
    # each package's parser reads the other's text, to the same samples
    assert ptel.parse_exposition(ref) == rtel.parse_exposition(port)
    assert ptel.parse_exposition(port) == rtel.parse_exposition(ref)


@pytest.mark.parametrize("bad", ["this is not a sample line at all!\n",
                                 'm{le="1" garbage} 3\n'])
def test_parsers_refuse_alike(bad):
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError):
            pkg.parse_exposition(bad)


def test_register_stats_refuses_alike():
    for pkg in PACKAGES.values():
        reg = pkg.MetricsRegistry()
        with pytest.raises(ValueError, match="not_declared"):
            reg.register_stats(pkg.schema.SERVICE_PREFIX,
                               {"not_declared": 0}, pkg.schema.SERVICE_STATS)
        reg.gauge("g_dup", "x")
        with pytest.raises(ValueError, match="duplicate"):
            reg.gauge("g_dup", "x")


# ---------------------------------------------------------------- histograms
def _hist(pkg, values, edges=None):
    h = pkg.Histogram("h", buckets=edges or pkg.schema.LATENCY_BUCKETS_S)
    for v in values:
        h.observe(v)
    return h


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_histogram_merge_dict_quantile_agree(seed):
    obs = _observations(seed)
    ref, port = _hist(rtel, obs[:120]), _hist(ptel, obs[:120])
    ref.merge(_hist(rtel, obs[120:]))
    port.merge(_hist(ptel, obs[120:]))
    assert port.to_dict() == ref.to_dict()
    assert (port.counts, port.sum, port.count) == (ref.counts, ref.sum,
                                                   ref.count)
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert port.quantile(q) == ref.quantile(q)
    # from_dict across packages, and the JSON loader
    for d in (ref.to_dict(), port.to_dict()):
        assert ptel.Histogram.from_dict(d).to_dict() == \
            rtel.Histogram.from_dict(d).to_dict()
        assert ptel.hist_from_json(d).to_dict() == \
            rtel.hist_from_json(d).to_dict()
    assert ptel.hist_from_json({"x": 1}) is rtel.hist_from_json({"x": 1})
    assert ptel.dumps_compact(port.to_dict()) == \
        rtel.metrics.dumps_compact(ref.to_dict())


def test_histogram_refusals_alike():
    for pkg in PACKAGES.values():
        a = _hist(pkg, [0.5], edges=(1.0, 2.0))
        with pytest.raises(ValueError):
            a.merge(_hist(pkg, [], edges=(1.0, 3.0)))
        with pytest.raises(ValueError):
            pkg.Histogram("h", buckets=(2.0, 1.0))
        with pytest.raises(ValueError):
            pkg.Histogram.from_dict({"le": [1.0, 2.0], "counts": [1]})
        with pytest.raises(ValueError):
            a.quantile(1.5)


# --------------------------------------------------------------------- spans
def _lifecycle(pkg):
    """A recorder fed a lifecycle with every kind of record: two served
    requests (prefill, decode and spec spans), one cancelled while queued,
    a shed, engine step spans and a duplicate finish."""
    rec = pkg.SpanRecorder()
    rec.submit(0, 1.0, prompt_len=8)
    rec.submit(1, 1.5, prompt_len=4)
    rec.submit(2, 1.75, prompt_len=12)
    rec.admit(0, 2.0, slot=0)
    rec.admit(2, 2.125, slot=1)
    rec.span("prefill", 0, 2.0, 2.5, lo=0, hi=8, tokens=1)
    rec.first_token(0, 2.5)
    rec.span("step", None, 2.0, 2.5, admit=1e-6, total=0.5)
    rec.span("decode", 0, 2.5, 3.0, tokens=3, k_steps=4)
    rec.span("prefill", 2, 3.0, 3.25, lo=0, hi=12, tokens=1)
    rec.first_token(2, 3.25)
    rec.span("spec", 2, 3.25, 3.5, tokens=2, drafted=4, accepted=1, k=4,
             cycles=1)
    rec.finish(0, 3.0, "length", n_tokens=4, pages_held=2)
    rec.finish(1, 3.5, "cancelled")
    rec.finish(2, 3.5, "error", n_tokens=3, pages_held=1)
    rec.shed(4.0, "saturated")
    rec.finish(0, 9.0, "error")
    return rec


def test_span_recorder_writes_the_same_traces(tmp_path):
    ref, port = _lifecycle(rtel), _lifecycle(ptel)
    assert port.records == ref.records
    assert port.terminals == ref.terminals and port.sheds == ref.sheds
    assert port.open_uids() == ref.open_uids() == []
    assert port.to_chrome_trace() == ref.to_chrome_trace()
    assert port.to_jsonl() == ref.to_jsonl()
    assert [json.loads(x) for x in port.to_jsonl().splitlines()] == \
        port.records
    paths = {name: pkg.write_trace(tmp_path / name, rec)
             for (name, pkg), rec in zip(PACKAGES.items(), (ref, port))}
    for a, b in zip(paths["reference"], paths["port"]):
        assert a.name == b.name and a.read_bytes() == b.read_bytes()


# ------------------------------------------------------- live stats declared
@pytest.fixture(scope="module")
def params():
    cfg = configs.get_smoke_config(ARCH)
    parent = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, parent, quantize_lm_params(parent)


@pytest.mark.parametrize("layout", ["contiguous", "paged", "speculative",
                                    "speculative paged"])
def test_register_stats_over_live_engine_stats(params, layout):
    """``register_stats`` takes the port engine's live stats, and a
    service's, before and after a served request: every key the port
    writes is declared, and every declared family renders."""
    cfg, parent, hqp = params
    kw = dict(page_size=8) if "paged" in layout else {}
    if "speculative" in layout:
        kw.update(draft_params=hqp, spec_k=2)
    eng = Engine(parent, cfg, n_slots=2, max_seq=64, device="cpu",
                 sched=SchedulerConfig(prefill_chunk=8), **kw)
    ptel.MetricsRegistry().register_stats(
        ptel.schema.ENGINE_PREFIX, eng.stats, ptel.schema.ENGINE_STATS)
    svc = Service(eng, ServiceConfig(queue_depth=2))
    t = svc.submit(Request(prompt=[5, 6, 7, 8, 9], max_new_tokens=3))
    svc.drain()
    assert t.finish_reason == "length"
    reg = ptel.MetricsRegistry()
    reg.register_stats(ptel.schema.ENGINE_PREFIX, eng.stats,
                       ptel.schema.ENGINE_STATS)
    reg.register_stats(ptel.schema.SERVICE_PREFIX, svc.stats,
                       ptel.schema.SERVICE_STATS)
    assert set(eng.stats) <= set(ptel.schema.ENGINE_STATS)
    assert all(type(v) in (int, float) for v in eng.stats.values())
    parsed = ptel.parse_exposition(svc.render_metrics())
    assert set(ptel.schema.metric_names()) <= set(parsed["types"])
    assert parsed["types"][ptel.schema.ENGINE_PREFIX + "kv_bytes"] == "gauge"
