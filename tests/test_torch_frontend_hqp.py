"""HQP and serving of the frontend configs (phi-3-vision-4.2b,
musicgen-medium) on the CPU, held against the JAX package on their smoke
configs with the same weights: the Fisher pass and ``compress`` on the
launcher's calibration batch (zero embeddings, as the reference's
launcher builds it); artifacts both ways, the top-level ``frontend``
``QuantizedLinear`` included; the serve launcher's lockstep tokens with
and without ``--hqp`` and from a saved artifact; the engine's refusal of a
frontend config; and the lockstep's ``--max-seq`` refusal where the
reference writes past its cache (ROADMAP C15). Tolerances in
``_torch_frontend_common``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_frontend_common import (ARCHS, assert_tokens_to_first_tie,  # noqa: E402,F401
                                    assert_tree_same, f32, jlockstep, make,
                                    np_tree, one_thread)
from repro.compress import compress as jcompress  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.launch import checkpoint as jckpt  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.serve import _calib_batch as j_calib_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.train.train_step import make_eval_step as jmake_eval  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.compress.artifact import compress  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core import pruning as pr  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.launch import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.serving import sampling as smp  # noqa: E402
from repro_torch.train.train_step import make_eval_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

S_FRAC = 2e-2           # a unit's S, of its family's largest (test_torch_hqp)
LEAF_REL = 5e-2         # a Fisher leaf's L2 error (_torch_train_common)
PROMPT, TOKENS, MAX_SEQ = 12, 8, 128
SERVE = ["--smoke", "--tokens", str(TOKENS), "--prompt-len", str(PROMPT)]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return make(request.param)


@pytest.fixture
def ref_weights(model, monkeypatch):
    """The port's launchers draw the reference's seed-0 weights."""
    tree = np_tree(model["jp"])
    monkeypatch.setattr(lm, "init_params", lambda cfg, seed=0, device=None:
                        from_jax_params(tree, device=device))
    return model


def _calib(model):
    jb = j_calib_batch(model["jcfg"], 2, 32)
    tb = serve._calib_batch(model["cfg"], 2, 32, device="cpu")
    assert tb["embeds"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    np.testing.assert_array_equal(f32(tb["embeds"]), f32(jb["embeds"]))
    return jb, tb


def test_compress_equals_reference(model):
    """On the launcher's calibration batch: the port's own Fisher pass
    within S_FRAC a unit and LEAF_REL a leaf (the ``frontend`` leaf
    included) of the reference's; given the reference's squared gradients,
    the ranking, the masks and Algorithm 1's history (each step judged by
    the eval step on the same batch) are the reference's exactly, no
    family touches the ``frontend`` linear, and the INT8 artifact's codes
    and scales, the frontend's included, are the reference's within C1."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    jb, tb = _calib(model)
    grad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(
        p, jcfg, b, model["ctx"], with_aux=False)[0]))
    jsq, _ = jsens.fisher_diag(grad, model["jp"], [jb])
    tsq_own, _ = sens.fisher_diag(sens.loss_grad_fn(
        lambda p, b: lm.loss_fn(p, cfg, b)), model["tp"], [tb])
    tsq = from_jax_params(np_tree(jsq), device="cpu")
    jspecs, tspecs = jsens.lm_prune_groups(jcfg), sens.lm_prune_groups(cfg)
    assert [(s.name, s.size) for s in tspecs] == [
        (s.name, s.size) for s in jspecs]
    assert not any(m[0][0] == "frontend" for s in tspecs
                   for m in s.members_all)
    for ts, js in zip(tspecs, jspecs):
        got = sens.group_sensitivity(tsq_own, ts).numpy()
        want = np.asarray(jsens.group_sensitivity(jsq, js))
        assert np.abs(got - want).max() <= S_FRAC * np.abs(want).max(), \
            ts.name
    a, b = f32(tsq_own["frontend"]["w"]), f32(jsq["frontend"]["w"])
    assert np.linalg.norm(a - b) <= LEAF_REL * max(np.linalg.norm(b), 1e-30)
    jr, tr = jpr.rank_units(jspecs, jsq), pr.rank_units(tspecs, tsq)
    np.testing.assert_array_equal(tr.spec_idx, jr.spec_idx)
    np.testing.assert_array_equal(tr.unit_idx, jr.unit_idx)
    n = tr.total // 2
    assert_tree_same(pr.apply_prune_masks(model["tp"], tr, n),
                     jpr.apply_prune_masks(model["jp"], jr, n))
    jev = jax.jit(jmake_eval(jcfg, model["ctx"]))
    tev = make_eval_step(cfg)
    jart = jcompress(model["jp"], jcfg, sq_grads=jsq,
                     eval_fn=lambda p: float(jev(p, jb)), log=lambda s: None,
                     hqp=jpipe.HQPConfig(weight_granularity="channel",
                                         step_frac=0.05, max_steps=3))
    tart = compress(model["tp"], cfg, sq_grads=tsq,
                    eval_fn=lambda p: float(tev(p, tb)), log=lambda s: None,
                    hqp=pipe.HQPConfig(step_frac=0.05, max_steps=3))
    jm, tm = jart.manifest.asdict(), tart.manifest.asdict()
    assert [(h["n_drop"], h["accuracy"], h["accepted"])
            for h in tm["history"]] == [
        (h["n_drop"], h["accuracy"], h["accepted"]) for h in jm["history"]]
    for key in ("n_drop", "total_units", "theta", "theta_by_family",
                "a_baseline", "a_final", "bytes_before", "bytes_after",
                "arch_hash"):
        assert tm[key] == jm[key], key
    assert isinstance(tart.params["frontend"], QuantizedLinear)
    assert_tree_same(tart.params, jart.params, c1=True)


def test_serve_launcher_matches_reference(ref_weights, capsys):
    """``serve`` (lockstep, zero embeddings) returns the reference
    launcher's tokens, on the reference's seed-0 weights; the reference's
    lockstep loop replayed here (``jlockstep``) gives the same tokens."""
    m = ref_weights
    argv = ["--arch", m["arch"]] + SERVE
    want = np.asarray(jserve.main(argv))
    again, _ = jlockstep(m["jp"], m["jcfg"], m["ctx"], 4, PROMPT, TOKENS,
                         MAX_SEQ)
    np.testing.assert_array_equal(again, want)
    got = serve.main(argv + ["--device", "cpu"])
    np.testing.assert_array_equal(got, want)
    capsys.readouterr()


def test_lockstep_sampling_keys_skip_the_frontend(model, monkeypatch,
                                                  capsys):
    """A sampled lockstep draws token t with the key of text position
    ``--prompt-len`` + t, as the reference's launcher: the frontend's
    positions do not count."""
    seen = []
    draw = smp.sample_batch

    def spy(logits, cfg, base, pos, *a, **kw):
        seen.append(pos.tolist())
        return draw(logits, cfg, base, pos, *a, **kw)
    monkeypatch.setattr(smp, "sample_batch", spy)
    serve.main(["--arch", model["arch"], "--smoke", "--device", "cpu",
                "--tokens", "4", "--prompt-len", "6", "--temperature", "0.8",
                "--seed", "7"])
    assert seen == [[6 + t] * 4 for t in range(4)]
    capsys.readouterr()


def _hqp_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith(
        ("[hqp] baseline", "[hqp] step", "[hqp] accuracy"))]


def test_serve_launcher_hqp_and_artifacts(ref_weights, capsys, tmp_path):
    """``serve --hqp``: the port's Fisher pass, Algorithm 1 and PTQ print
    the reference launcher's baseline, step and accuracy lines, and its
    tokens are the reference's up to the first near tie (C2, C1's codes).
    The reference's saved artifact loads in the port with its bits (the
    top-level frontend linear a QuantizedLinear) and ``serve
    --load-artifact`` serves the same tokens; the port's own artifact
    loads in the reference with its bits."""
    m = ref_weights
    art_dir = str(tmp_path / "jax")
    argv = ["--arch", m["arch"]] + SERVE
    want = np.asarray(jserve.main(argv + ["--hqp", "--save-artifact",
                                          art_dir]))
    want_lines = _hqp_lines(capsys.readouterr().out)
    jart = jckpt.load_artifact(art_dir)
    ctx8 = dataclasses.replace(m["ctx"], quantized_kv=True)
    again, gaps = jlockstep(jart.params, m["jcfg"], ctx8, 4, PROMPT, TOKENS,
                            MAX_SEQ)
    np.testing.assert_array_equal(again, want)
    got = serve.main(argv + ["--device", "cpu", "--hqp", "--save-artifact",
                             str(tmp_path / "port")])
    assert _hqp_lines(capsys.readouterr().out) == want_lines
    assert_tokens_to_first_tie(got, want, gaps)
    loaded = ckpt.load_artifact(art_dir, device="cpu")
    assert isinstance(loaded.params["frontend"], QuantizedLinear)
    assert_tree_same(loaded.params, jart.params)
    assert loaded.manifest.asdict() == jart.manifest.asdict()
    got = serve.main(argv + ["--device", "cpu", "--load-artifact", art_dir])
    assert_tokens_to_first_tie(got, want, gaps)
    port = ckpt.load_artifact(str(tmp_path / "port"), device="cpu")
    assert_tree_same(port.params,
                     jckpt.load_artifact(str(tmp_path / "port")).params)
    capsys.readouterr()


def test_engine_refuses_frontend_configs(model):
    """The engine serves token-only archs, as the reference's: a frontend
    config is refused when the engine is made, and so is ``serve
    --engine``."""
    with pytest.raises(NotImplementedError, match="frontend"):
        Engine(model["tp"], model["cfg"], device="cpu")
    with pytest.raises(NotImplementedError):
        JEngine(model["jp"], model["jcfg"])
    with pytest.raises(NotImplementedError, match="frontend"):
        serve.main(["--arch", model["arch"], "--smoke", "--device", "cpu",
                    "--engine", "--tokens", "4", "--prompt-len", "6"])


def test_c15_lockstep_past_max_seq(model, capsys):
    """ROADMAP C15. A lockstep batch whose frontend positions, prompt and
    new tokens pass ``--max-seq``: the reference writes its last positions
    where its cache ends (``dynamic_update_slice`` clamps the start) and
    returns other tokens than with room, silently; the port refuses with
    a message before any device work."""
    argv = ["--arch", model["arch"], "--smoke", "--tokens", "32",
            "--prompt-len", "32"]
    room = np.asarray(jserve.main(argv + ["--max-seq", "128"]))
    short = np.asarray(jserve.main(argv + ["--max-seq", "64"]))
    assert short.shape == room.shape
    # the step that picks token i writes position n_fr + 32 + i - 1:
    # token `past` is the first whose step writes past the cache
    past = 64 - model["cfg"].frontend.n_embeds - 32 + 1
    np.testing.assert_array_equal(short[:, :past], room[:, :past])
    assert (short != room).any()
    capsys.readouterr()
    with pytest.raises(SystemExit):
        serve.main(argv + ["--max-seq", "64", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "--max-seq >= 71" in err and "8 frontend positions" in err


def test_c15_lockstep_exact_fit(model):
    """ROADMAP C15 at the edge: a batch whose frontend positions, prompt
    and new tokens less one (the last token is never fed back) fill
    ``--max-seq`` exactly is served, with the tokens it gets with room to
    spare."""
    n_fr = model["cfg"].frontend.n_embeds
    argv = ["--arch", model["arch"], "--smoke", "--device", "cpu",
            "--prompt-len", "32", "--tokens", str(64 - n_fr - 32 + 1)]
    fit = serve.main(argv + ["--max-seq", "64"])
    room = serve.main(argv + ["--max-seq", "128"])
    assert fit.shape == (4, 64 - n_fr - 32 + 1)
    np.testing.assert_array_equal(fit, room)
