"""The port's deadline-feasibility admission (``repro_torch.serving.
admission``) against the JAX package's, exactly: the same ``observe``
sequence gives the same EWMAs, the same warm state, the same verdicts,
predictions and clamped Retry-Afters; the same configs are refused; and the
port's ``Service`` sheds, prices its backlog and advertises Retry-After as
the reference ``Service`` does on the same submits."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import admission as radm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.serving import Service as JService  # noqa: E402
from repro.serving import ServiceConfig as JServiceConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import admission as padm  # noqa: E402
from repro_torch.serving import (Engine, Request, SchedulerConfig,  # noqa: E402
                                 Service, ServiceConfig)

ARCH = "qwen3-0.6b"
CONFIGS = [{}, dict(ewma_alpha=0.7, safety=1.0, min_observations=1),
           dict(ewma_alpha=0.05, safety=2.5, min_observations=5,
                retry_floor_s=0.5, retry_cap_s=2.0)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(seed, n=80):
    """(prefill tokens, decode tokens, wall s) observations, degenerate
    ones (no tokens of a kind, zero or negative wall) among them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pf = int(rng.choice([0, 0, rng.randint(1, 400)]))
        dec = int(rng.choice([0, rng.randint(1, 64)]))
        wall = float(rng.choice([0.0, -1e-3, rng.uniform(1e-4, 0.2)]))
        out.append((pf, dec, wall))
    return out


def _state(ctrl):
    return (ctrl.prefill_tok_s, ctrl.decode_tok_s, ctrl.warm)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg_kw", CONFIGS, ids=["default", "fast", "slow"])
def test_controller_equals_the_reference(seed, cfg_kw):
    ref = radm.AdmissionController(radm.AdmissionConfig(**cfg_kw))
    port = padm.AdmissionController(padm.AdmissionConfig(**cfg_kw))
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    rng = np.random.RandomState(100 + seed)
    for i, (pf, dec, wall) in enumerate(_samples(seed)):
        if i % 3:
            ref.observe(pf, dec, wall)
            port.observe(pf, dec, wall)
        else:       # the engine's last_step form
            step = {"prefill_tokens": pf, "decode_tokens": dec,
                    "wall_s": wall, "phases": {}}
            ref.observe_step(step)
            port.observe_step(step)
        assert _state(port) == _state(ref)
        if not ref.warm:
            continue
        for _ in range(4):
            shape = (int(rng.randint(1, 300)), int(rng.randint(1, 64)))
            backlog = (int(rng.randint(0, 2000)), int(rng.randint(0, 300)))
            deadline = float(10.0 ** rng.uniform(-4, 1.5))
            want = ref.feasible(*shape, backlog, deadline)
            got = port.feasible(*shape, backlog, deadline)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert port.work_s(*backlog) == ref.work_s(*backlog)
            assert port.clamp_retry(deadline) == ref.clamp_retry(deadline)
    assert ref.warm                    # the verdicts above were reached
    before = _state(port)
    port.observe_step(None)            # nothing to fold in
    assert _state(port) == before


@pytest.mark.parametrize("bad", [dict(ewma_alpha=0.0), dict(ewma_alpha=1.5),
                                 dict(safety=0.0), dict(min_observations=0),
                                 dict(retry_floor_s=2.0, retry_cap_s=1.0)])
def test_configs_refused_alike(bad):
    for mod in (radm, padm):
        with pytest.raises(ValueError):
            mod.AdmissionConfig(**bad)


# ------------------------------------------------------- through the Service
@pytest.fixture(scope="module")
def both():
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    return ((jcfg, jlm.init_params(jax.random.PRNGKey(0), jcfg)),
            (cfg, lm.init_params(cfg, seed=0, device="cpu")))


def _warm(mod, **kw):
    ctrl = mod.AdmissionController(mod.AdmissionConfig(**kw))
    for _ in range(ctrl.cfg.min_observations):
        ctrl.observe(1000.0, 100.0, 1.0)
    return ctrl


def _services(both, n_slots, queue_depth, retry_after_s=0.25, **ctrl_kw):
    (jcfg, jparams), (cfg, params) = both
    jeng = JEngine(jparams, jcfg, n_slots=n_slots, max_seq=64,
                   sched=JSchedulerConfig(prefill_chunk=8))
    eng = Engine(params, cfg, n_slots=n_slots, max_seq=64, device="cpu",
                 sched=SchedulerConfig(prefill_chunk=8))
    now = [0.0]
    return (JService(jeng, JServiceConfig(queue_depth=queue_depth,
                                          retry_after_s=retry_after_s),
                     clock=lambda: now[0], admission=_warm(radm, **ctrl_kw)),
            Service(eng, ServiceConfig(queue_depth=queue_depth,
                                       retry_after_s=retry_after_s),
                    clock=lambda: now[0], admission=_warm(padm, **ctrl_kw)))


def _submit_both(svcs, prompt, max_new, deadline_s=None):
    jsvc, svc = svcs
    jt = jsvc.submit(JRequest(prompt=prompt, max_new_tokens=max_new),
                     deadline_s=deadline_s)
    t = svc.submit(Request(prompt=prompt, max_new_tokens=max_new),
                   deadline_s=deadline_s)
    assert (t is None) == (jt is None)
    assert svc.last_shed == jsvc.last_shed
    assert svc.stats == jsvc.stats
    return t


def test_service_sheds_and_prices_backlog_as_the_reference(both):
    """Infeasible at submit, priced behind admitted work, deadline-free
    never checked, then saturation with a backlog-priced Retry-After: the
    same decisions, the same ``last_shed`` (reason, Retry-After,
    prediction) and the same stats in both packages. The port's requests
    then run to completion."""
    svcs = _services(both, n_slots=1, queue_depth=2, safety=1.0,
                     retry_floor_s=0.01)
    cfg = both[1][0]
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                              10).tolist()
    assert _submit_both(svcs, prompt, 10, deadline_s=0.001) is None
    assert svcs[1].last_shed["reason"] == "infeasible"
    assert _submit_both(svcs, prompt, 30, deadline_s=10.0) is not None
    assert _submit_both(svcs, prompt, 30, deadline_s=10.0) is not None
    # behind two 30-token requests: 0.93 s predicted against 0.8
    assert _submit_both(svcs, prompt, 30, deadline_s=0.8) is None
    assert svcs[1].last_shed["predicted_s"] == pytest.approx(0.93)
    assert _submit_both(svcs, prompt, 30) is not None
    # n_slots + queue_depth = 3 in flight: saturated, Retry-After priced
    assert _submit_both(svcs, prompt, 2, deadline_s=60.0) is None
    assert svcs[1].last_shed["reason"] == "saturated"
    assert svcs[1].last_shed["retry_after_s"] != 0.25
    svc = svcs[1]
    svc.drain()
    assert svc.stats["completed"] == 3 and svc.stats["expired"] == 0


def test_static_cap_holds_when_everything_looks_feasible(both):
    svcs = _services(both, n_slots=1, queue_depth=1)
    for svc in svcs:
        svc.admission = None
    fast = [_warm(radm), _warm(padm)]
    for svc, ctrl in zip(svcs, fast):
        for _ in range(3):
            ctrl.observe(1e9, 1e9, 1.0)
        svc.admission = ctrl
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, both[1][0].vocab_size, 6).tolist()
               for _ in range(3)]
    assert _submit_both(svcs, prompts[0], 2, deadline_s=60.0) is not None
    assert _submit_both(svcs, prompts[1], 2, deadline_s=60.0) is not None
    assert _submit_both(svcs, prompts[2], 2, deadline_s=60.0) is None
    assert svcs[1].last_shed["reason"] == "saturated"
    assert svcs[1].stats["shed_infeasible"] == 0
    svcs[1].drain()
    assert svcs[1].stats["completed"] == 2
