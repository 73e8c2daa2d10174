"""The port's HQP compression path on the CPU (the plain versions of the
kernels), held against the JAX package on the qwen3-0.6b smoke config with
the same weights (carried across by ``from_jax_params``) and the same
calibration batch: the train-route forward and loss, the accuracy eval, the
Fisher sensitivities, the prune families, ranking, masks and compaction,
Algorithm 1, and ``compress``; then the port's own artifact served by the
engine.

Tolerances and exact equalities:
  * hidden states: the frameworks round ``rsqrt``, RoPE and each bf16
    product at their own places, one bf16 ulp a layer; over the two layers
    that is at most 4 ulps of |h| <~ 4: atol 6.25e-2, rtol 2^-7. The loss
    (a mean over 62 positions, f32): rtol 1e-4;
  * accuracy: equal. Predictions may differ only where the reference's
    logits hold a near tie (ROADMAP C2): equal wherever its top-2 gap
    exceeds 0.05, twice the logit tolerance of the decode tests (0.02) on
    these larger forward differences;
  * Fisher: gradients are bf16 in both frameworks and differ at the ulp
    level, so the per-unit sensitivities S are held within 2 % of their
    family's largest S;
  * given the REFERENCE's squared gradients, everything integer is exact:
    the ranking, n_drop, the masked and compacted tensors, the manifest's
    integers; and ``arch_fingerprint`` is the same hash. The INT8 artifact
    is held to ROADMAP C1: the reference's ``compress`` quantizes under
    ``jit``, where XLA divides by 127 through a multiply by fl(1/127), so a
    scale may sit one f32 ulp from the port's true quotient and a code one
    step away.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compress import compress as jcompress  # noqa: E402
from repro.compress.artifact import arch_fingerprint as jfingerprint  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.launch.serve import _calib_batch as j_calib_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro.train.train_step import make_eval_step as jmake_eval  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.compress.artifact import arch_fingerprint, compress  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core import pruning as pr  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request, SchedulerConfig  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.train.train_step import make_eval_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-0.6b"
HIDDEN = dict(rtol=2 ** -7, atol=6.25e-2)
TIE_GAP = 0.05
S_FRAC = 2e-2


@pytest.fixture(scope="module")
def ref():
    """Both configs, the JAX params and the port's copy, the launcher's
    calibration batch in both frameworks, and the reference's Fisher
    diagonal in both."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    ctx = default_ctx()
    jb = j_calib_batch(jcfg, 2, 32)
    grad = jax.jit(jax.grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b, ctx, with_aux=False)[0]))
    jsq, _ = jsens.fisher_diag(grad, jp, [jb])
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(
        jcfg=jcfg, cfg=configs.get_smoke_config(ARCH), ctx=ctx, jp=jp,
        tp=from_jax_params(to_np(jp), device="cpu"), jb=jb,
        tb=serve._calib_batch(configs.get_smoke_config(ARCH), 2, 32,
                              device="cpu"),
        jsq=jsq, tsq=from_jax_params(to_np(jsq), device="cpu"))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _layer(jtree, g):
    """Layer g of the JAX stacked block tree."""
    return jax.tree.map(lambda t: t[g], jtree["blocks"][0])


def _assert_same(t, j, where):
    """A port subtree equals the JAX one exactly; QuantizedLinear codes and
    scales within C1's step and ulp."""
    if isinstance(t, QuantizedLinear):
        assert tuple(t.w_q.shape) == j.w_q.shape, where
        codes = t.w_q.numpy().astype(int) - np.asarray(j.w_q, int)
        assert np.abs(codes).max() <= 1, where
        np.testing.assert_array_max_ulp(t.scale.numpy(), np.asarray(j.scale),
                                        maxulp=1)
    elif isinstance(t, dict):
        assert sorted(t) == sorted(j), where
        for k in t:
            _assert_same(t[k], j[k], f"{where}/{k}")
    else:
        assert tuple(t.shape) == j.shape, where
        np.testing.assert_array_equal(_f32(t), _f32(j), err_msg=where)


def _assert_same_params(tp, jp):
    """The port's per-layer tree equals the JAX stacked tree, exactly."""
    _assert_same(tp["embed"], jp["embed"], "embed")
    _assert_same(tp["final_norm"], jp["final_norm"], "final_norm")
    for g, blk in enumerate(tp["blocks"]):
        _assert_same(blk, _layer(jp, g), f"L{g}")


# ------------------------------------------------------------------ train route
def test_forward_and_loss_match_reference(ref):
    h = lm.forward(ref["tp"], ref["cfg"], ref["tb"])
    hj, _ = jlm.forward(ref["jp"], ref["jcfg"], ref["jb"], ref["ctx"])
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == hj.shape
    np.testing.assert_allclose(_f32(h), _f32(hj), **HIDDEN)
    loss = lm.loss_fn(ref["tp"], ref["cfg"], ref["tb"])
    lj, _ = jlm.loss_fn(ref["jp"], ref["jcfg"], ref["jb"], ref["ctx"],
                        with_aux=False)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-4)
    # the chunked cross-entropy sums the same terms as one chunk
    np.testing.assert_allclose(
        float(lm.loss_fn(ref["tp"], ref["cfg"], ref["tb"], ce_chunk=7)),
        float(loss), rtol=1e-6)


def test_eval_step_accuracy_matches_reference(ref):
    """Tokens built so that every even position's target is the reference's
    own prediction (a prediction depends only on the tokens up to it), so
    the accuracy is at least 1/2 and the comparison is not one of zeros."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    jeval = jax.jit(jmake_eval(jcfg, ref["ctx"]))
    hidden = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t})[0])
    tokens = np.asarray(ref["jb"]["tokens"]).copy()
    for i in range(0, tokens.shape[1] - 1, 2):
        logits = jlm.logits_fn(ref["jp"], jcfg,
                               hidden(ref["jp"], jnp.asarray(tokens)))
        tokens[:, i + 1] = np.asarray(jnp.argmax(logits[:, i], -1))
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    want = float(jeval(ref["jp"], {"tokens": jt}))
    got = float(make_eval_step(cfg)(ref["tp"], {"tokens": tt}))
    assert want >= 0.5
    jl = np.asarray(jlm.logits_fn(ref["jp"], jcfg,
                                  hidden(ref["jp"], jt)))[:, :-1]
    tl = _f32(lm.logits_fn(ref["tp"], cfg, lm.forward(ref["tp"], cfg,
                                                      {"tokens": tt})))
    top2 = np.sort(jl, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > TIE_GAP
    np.testing.assert_array_equal(tl[:, :-1].argmax(-1)[decided],
                                  jl.argmax(-1)[decided])
    if decided.all():
        assert got == want
    else:
        assert abs(got - want) <= (~decided).mean()


# ------------------------------------------------------------------ sensitivity
def test_prune_groups_equal_reference(ref):
    """Names, kinds, sizes and order equal; each member is the JAX member
    with ("__stack__", g, "blocks", 0) read as ("blocks", g)."""
    jspecs = jsens.lm_prune_groups(ref["jcfg"])
    tspecs = sens.lm_prune_groups(ref["cfg"])
    assert [(s.name, s.kind, s.size) for s in tspecs] == [
        (s.name, s.kind, s.size) for s in jspecs]
    for ts, js in zip(tspecs, jspecs):
        for attr in ("members_grad", "members_all"):
            want = [(("blocks", p[1]) + p[4:], ax, blk, off)
                    for p, ax, blk, off in getattr(js, attr)]
            assert getattr(ts, attr) == want, ts.name
    full_t = sens.lm_prune_groups(configs.get_config(ARCH))
    full_j = jsens.lm_prune_groups(jconfigs.get_config(ARCH))
    assert [(s.name, s.size) for s in full_t] == [(s.name, s.size)
                                                  for s in full_j]


def test_fisher_sensitivities_match_reference(ref):
    tsq, n = sens.fisher_diag(
        sens.loss_grad_fn(lambda p, b: lm.loss_fn(p, ref["cfg"], b)),
        ref["tp"], [ref["tb"]])
    assert n == 1
    assert tsq["blocks"][0]["attn"]["wq"]["w"].dtype == torch.float32
    for ts, js in zip(sens.lm_prune_groups(ref["cfg"]),
                      jsens.lm_prune_groups(ref["jcfg"])):
        want = np.asarray(jsens.group_sensitivity(ref["jsq"], js))
        got = sens.group_sensitivity(tsq, ts).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=S_FRAC * np.abs(want).max(),
                                   err_msg=ts.name)
    # the params were not touched by autograd
    assert not ref["tp"]["embed"]["table"].requires_grad


@pytest.mark.parametrize("frac", [0.15, 0.4])
def test_rank_mask_compact_exact_given_reference_grads(ref, frac):
    jspecs = jsens.lm_prune_groups(ref["jcfg"])
    tspecs = sens.lm_prune_groups(ref["cfg"])
    jr = jpr.rank_units(jspecs, ref["jsq"])
    tr = pr.rank_units(tspecs, ref["tsq"])
    np.testing.assert_array_equal(tr.spec_idx, jr.spec_idx)
    np.testing.assert_array_equal(tr.unit_idx, jr.unit_idx)
    # S itself: the reference sums f32 in its own order, the port in f64
    np.testing.assert_allclose(tr.s_values, jr.s_values, rtol=1e-5)
    n = int(frac * tr.total)
    tm = pr.apply_prune_masks(ref["tp"], tr, n)
    jm = jpr.apply_prune_masks(ref["jp"], jr, n)
    _assert_same_params(tm, jm)
    tc = pr.compact_params(tm, tr, n)
    jc = jpr.compact_params(jm, jr, n)
    _assert_same_params(tc, jc)
    assert pr.param_bytes(tc) == jpr.param_bytes(jc) < pr.param_bytes(
        ref["tp"])
    # masking copies: the input params keep their values
    _assert_same_params(ref["tp"], ref["jp"])


def _zeroed_ffn_columns(params, specs, get):
    n = 0
    for sp in specs:
        if sp.kind == "ffn_col":
            w = _f32(get(params, sp.members_all[0][0]))
            n += int(np.sum(np.all(w == 0, axis=0)))
    return n


@pytest.mark.parametrize("slope,baseline,max_steps", [
    (0.0005, 1.0, 50),     # accepts until the drop passes Δ_ax, then stops
    (0.0, 1.0, 3),         # accepts every step up to max_steps
    (None, 1.0, 10),       # an immediate reject: nothing is pruned
])
def test_conditional_prune_history_equals_reference(ref, slope, baseline,
                                                    max_steps):
    """Algorithm 1 with a fixed eval_fn in both packages: ``baseline`` on
    its first call (the unpruned params), then 1 - slope x the number of
    zeroed FFN columns of the masked params, or 0.5 always. The same n_drop
    and the same accept/reject history."""
    def fixed_eval(specs, get):
        calls = []

        def fn(p):
            calls.append(1)
            if len(calls) == 1:
                return baseline
            if slope is None:
                return 0.5
            return 1.0 - slope * _zeroed_ffn_columns(p, specs, get)
        return fn

    jspecs = jsens.lm_prune_groups(ref["jcfg"])
    tspecs = sens.lm_prune_groups(ref["cfg"])
    jcfg_h = jpipe.HQPConfig(step_frac=0.05, max_steps=max_steps)
    tcfg_h = pipe.HQPConfig(step_frac=0.05, max_steps=max_steps)
    jlog, tlog = [], []
    jres = jpipe.conditional_prune(ref["jp"], jspecs, ref["jsq"],
                                   fixed_eval(jspecs, jsens._get), jcfg_h,
                                   log=jlog.append)
    tres = pipe.conditional_prune(ref["tp"], tspecs, ref["tsq"],
                                  fixed_eval(tspecs, sens._get), tcfg_h,
                                  log=tlog.append)
    assert tres.n_drop == jres.n_drop and tres.theta == jres.theta
    strip = lambda h: [(s.step, s.n_drop, s.accuracy, s.accepted) for s in h]
    assert strip(tres.history) == strip(jres.history)
    assert tlog == jlog
    if slope is None:
        assert tres.n_drop == 0 and not tres.history[0].accepted
    _assert_same_params(tres.params_compact, jres.params_compact)


def test_compress_manifest_and_int8_equal_reference(ref):
    jspecs = jsens.lm_prune_groups(ref["jcfg"])
    tspecs = sens.lm_prune_groups(ref["cfg"])
    jfn = lambda p: 1.0 - 0.0005 * _zeroed_ffn_columns(p, jspecs, jsens._get)
    tfn = lambda p: 1.0 - 0.0005 * _zeroed_ffn_columns(p, tspecs, sens._get)
    jart = jcompress(ref["jp"], ref["jcfg"], sq_grads=ref["jsq"],
                     eval_fn=jfn, log=lambda s: None,
                     hqp=jpipe.HQPConfig(weight_granularity="channel",
                                         step_frac=0.05, max_steps=3))
    tart = compress(ref["tp"], ref["cfg"], sq_grads=ref["tsq"], eval_fn=tfn,
                    log=lambda s: None,
                    hqp=pipe.HQPConfig(step_frac=0.05, max_steps=3))
    jm, tm = jart.manifest.asdict(), tart.manifest.asdict()
    for key in ("arch", "track", "bits", "bytes_before", "bytes_after",
                "pruned", "n_drop", "total_units", "vocab_size", "arch_hash",
                "theta", "theta_by_family", "a_baseline", "a_final"):
        assert tm[key] == jm[key], key
    assert tm["quantized_fraction"] == pytest.approx(jm["quantized_fraction"])
    assert [(h["n_drop"], h["accepted"]) for h in tm["history"]] == [
        (h["n_drop"], h["accepted"]) for h in jm["history"]]
    assert tart.manifest.summary().splitlines()[0] == \
        jart.manifest.summary().splitlines()[0]
    _assert_same_params(tart.params, jart.params)
    assert set(tart.seconds) == {"compact", "ptq"}


def test_arch_fingerprint_equals_reference():
    for get_t, get_j in ((configs.get_smoke_config,
                          jconfigs.get_smoke_config),
                         (configs.get_config, jconfigs.get_config)):
        assert arch_fingerprint(get_t(ARCH)) == jfingerprint(get_j(ARCH))


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def artifact():
    """The launcher's HQP artifact of the port's own smoke model (3 prune
    steps)."""
    cfg = configs.get_smoke_config(ARCH)
    params = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, serve.build_artifact(params, cfg, prune_steps=3,
                                     log=lambda s: None)


def test_build_artifact_stages(artifact):
    cfg, art = artifact
    m = art.manifest
    assert m.pruned and len(m.history) == 3 and m.n_drop > 0
    assert m.total_units == cfg.n_layers * (cfg.n_kv_heads + cfg.d_ff)
    assert set(art.seconds) == {"fisher", "evals", "compact", "ptq"}
    assert len(art.seconds["evals"]) == 1 + len(m.history)
    # mask == compact: the validated masked model and the compacted one
    # compute the same accuracy and (to bf16 rounding) the same hidden states
    res = art.prune
    batch = serve._calib_batch(cfg, 2, 32, device="cpu")
    ev = make_eval_step(cfg)
    assert float(ev(res.params_sparse, batch)) == float(
        ev(res.params_compact, batch)) == m.a_final
    np.testing.assert_allclose(
        _f32(lm.forward(res.params_compact, cfg, batch)),
        _f32(lm.forward(res.params_sparse, cfg, batch)), rtol=0.05,
        atol=0.05)
    assert all(isinstance(b["mlp"]["down"], QuantizedLinear)
               for b in art.params["blocks"])
    # the layers are pruned unevenly here, so the compacted FFN is ragged
    assert art.params["blocks"][0]["mlp"]["up"].w_q.shape[1] < cfg.d_ff


@pytest.mark.parametrize("page_size", [None, 16])
def test_pruned_artifact_engine_equals_serial(artifact, page_size):
    cfg, art = artifact
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (11, 5, 19)]
    eng = Engine(art.params, cfg, n_slots=2, max_seq=48,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=3),
                 quantized_kv=True, device="cpu", page_size=page_size)
    res = eng.run([Request(prompt=p, max_new_tokens=8) for p in prompts],
                  arrival_ticks=[0, 1, 4])
    for i, p in enumerate(prompts):
        assert res[i].tokens == serial_decode(
            art.params, cfg, p, 8, max_seq=48, quantized_kv=True,
            device="cpu"), i


def test_serve_cli_hqp_prints_the_manifest(capsys):
    serve.main(["--smoke", "--device", "cpu", "--engine", "--hqp",
                "--prune-steps", "3", "--tokens", "6", "--prompt-len", "9",
                "--max-seq", "32", "--page-size", "16"])
    out = capsys.readouterr().out
    assert "[hqp] baseline acc=" in out and "[hqp] step   3" in out
    assert "[hqp] artifact(qwen3-0.6b-smoke/int8)" in out
    assert "[hqp] stage seconds: Fisher" in out
    assert "token-identical to serial decode" in out
