"""The port's checkpoints and artifacts on disk, on the CPU: round trips,
the commit protocol, an exact resume, and the JAX package's layout, which
makes each package read what the other wrote; the train launcher's resume
and its SIGTERM exit.

Exact equalities throughout: a checkpoint or an artifact holds the arrays'
bits (bf16 as its uint16 view), so every value read back, by either
package, equals the value written. The engines' tokens on a port-written
artifact agree up to ROADMAP C2: where they first differ, the reference's
logits must hold an exact tie between the two tokens."""
import dataclasses
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import checkpoint as jckpt  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro.sharding.rules import path_str  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.compress.artifact import compress  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core import pruning as pr  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.compress.quantize import quantize_lm_params  # noqa: E402
from repro_torch.launch import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.weights import stack_blocks, to_numpy  # noqa: E402

ARCH = "qwen3-0.6b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batches(cfg, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (2, 16)) for _ in range(n)]


def _raw(x) -> np.ndarray:
    """The stored bits of a leaf of either package: bf16 as uint16."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat_port(state) -> dict:
    return {k: _raw(v) for k, v in _walk(stack_blocks(state), ())}


def _walk(node, path):
    if isinstance(node, QuantizedLinear):
        yield "/".join(path + ("w_q",)), node.w_q
        yield "/".join(path + ("scale",)), node.scale
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, path + (str(i),))
    else:
        yield "/".join(path), node


def _flat_ref(state) -> dict:
    return {path_str(p): _raw(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(state)[0]}


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def trained():
    """The port's smoke model after two AdamW steps, f32 and INT8 moments."""
    cfg = configs.get_smoke_config(ARCH)
    out = {}
    for state_dtype in ("f32", "int8"):
        ocfg = opt.AdamWConfig(lr=1e-3, state_dtype=state_dtype)
        p = lm.init_params(cfg, seed=0, device="cpu")
        o = opt.adamw_init(p, ocfg)
        step = make_train_step(cfg, ocfg)
        for t in _batches(cfg, 2):
            p, o, _ = step(p, o, {"tokens": torch.as_tensor(t)})
        out[state_dtype] = (p, o)
    return cfg, out


def _like(cfg, state_dtype):
    p = lm.init_params(cfg, seed=1, device="cpu")
    return p, opt.adamw_init(p, opt.AdamWConfig(state_dtype=state_dtype))


# ------------------------------------------------------------------ protocol
@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_save_restore_roundtrip(trained, tmp_path, state_dtype):
    cfg, states = trained
    state = states[state_dtype]
    ckpt.save(str(tmp_path), 5, state, {"arch": ARCH})
    restored, meta = ckpt.restore(str(tmp_path), _like(cfg, state_dtype))
    assert meta["step"] == 5 and meta["arch"] == ARCH
    _assert_same(_flat_port(restored), _flat_port(state))
    assert isinstance(restored, tuple) and isinstance(
        restored[0]["blocks"], list)


def test_restore_refuses_another_shape(trained, tmp_path):
    cfg, states = trained
    ckpt.save(str(tmp_path), 1, states["f32"][0])
    wide = lm.init_params(dataclasses.replace(cfg, d_ff=2 * cfg.d_ff),
                          seed=0, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), wide)


def test_latest_and_prune(trained, tmp_path):
    _, states = trained
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, states["f32"][0])
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.prune_old(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_000000003",
                                            "step_000000004"]


def test_torn_checkpoint_ignored(trained, tmp_path):
    cfg, states = trained
    ckpt.save(str(tmp_path), 1, states["f32"][0])
    torn = tmp_path / "step_000000002"      # the writer died mid-write
    torn.mkdir()
    (torn / "meta.json").write_text("{}")
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, meta = ckpt.restore(str(tmp_path), lm.init_params(cfg, device="cpu"))
    assert meta["step"] == 1
    with pytest.raises(FileNotFoundError, match="not committed"):
        ckpt.restore(str(tmp_path), lm.init_params(cfg, device="cpu"), step=2)
    with pytest.raises(FileNotFoundError, match="no committed"):
        ckpt.restore(str(tmp_path / "empty"), states["f32"][0])


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_resume_exact_training(tmp_path, state_dtype):
    """Train 4 steps, checkpoint at 2, resume: params and moments equal the
    uninterrupted run's, bit for bit."""
    cfg = configs.get_smoke_config(ARCH)
    ocfg = opt.AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    step = make_train_step(cfg, ocfg)
    batches = [{"tokens": torch.as_tensor(t)} for t in _batches(cfg, 4)]
    p = lm.init_params(cfg, seed=0, device="cpu")
    o = opt.adamw_init(p, ocfg)
    for b in batches[:2]:
        p, o, _ = step(p, o, b)
    ckpt.save(str(tmp_path), 2, (p, o))
    for b in batches[2:]:
        p, o, _ = step(p, o, b)
    (p2, o2), meta = ckpt.restore(str(tmp_path), _like(cfg, state_dtype))
    for b in batches[meta["step"]:]:
        p2, o2, _ = step(p2, o2, b)
    _assert_same(_flat_port((p2, o2)), _flat_port((p, o)))


# ------------------------------------------------------------------ across
@pytest.fixture(scope="module")
def reference():
    jcfg = jconfigs.get_smoke_config(ARCH)
    return jcfg, jlm.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_reference_restores_a_port_checkpoint(trained, reference, tmp_path,
                                              state_dtype):
    _, states = trained
    jcfg, jp = reference
    ckpt.save(str(tmp_path), 2, states[state_dtype])
    like = (jp, jopt.adamw_init(jp,
                                jopt.AdamWConfig(state_dtype=state_dtype)))
    restored, meta = jckpt.restore(str(tmp_path), like)
    assert meta["step"] == 2
    _assert_same(_flat_ref(restored), _flat_port(states[state_dtype]))


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_port_restores_a_reference_checkpoint(reference, tmp_path,
                                              state_dtype):
    jcfg, jp = reference
    jocfg = jopt.AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    grads = jax.tree.map(lambda t: 0.1 * t, jp)
    update = jax.jit(lambda p, g, o: jopt.adamw_update(p, g, o, jocfg))
    p, o = update(jp, grads, jopt.adamw_init(jp, jocfg))
    jckpt.save(str(tmp_path), 1, (p, o))
    restored, meta = ckpt.restore(
        str(tmp_path), _like(configs.get_smoke_config(ARCH), state_dtype))
    assert meta["step"] == 1
    _assert_same(_flat_port(restored), _flat_ref((p, o)))


# ------------------------------------------------------------------ artifacts
@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A pruned INT8 artifact of the port's smoke model, written by the
    port."""
    cfg = configs.get_smoke_config(ARCH)
    params = lm.init_params(cfg, seed=0, device="cpu")
    art = compress(params, cfg,
                   sq_grads=tree.map_(lambda t: t.float().abs(), params),
                   eval_fn=lambda p: 1.0,
                   hqp=pipe.HQPConfig(step_frac=0.1, max_steps=2),
                   log=lambda s: None)
    assert art.manifest.n_drop > 0
    path = ckpt.save_artifact(
        str(tmp_path_factory.mktemp("art") / "artifact"), art)
    return cfg, art, path


def test_artifact_roundtrip(artifact):
    _, art, path = artifact
    loaded = ckpt.load_artifact(path, device="cpu")
    assert loaded.manifest == art.manifest
    _assert_same(_flat_port(loaded.params), _flat_port(art.params))


def test_reference_loads_a_port_artifact(artifact):
    _, art, path = artifact
    loaded = jckpt.load_artifact(path)
    assert loaded.manifest.asdict() == art.manifest.asdict()
    assert isinstance(loaded.params["blocks"], tuple)
    _assert_same(_flat_ref(loaded.params), _flat_port(art.params))


def _reference_logits(jp, jcfg, ctx, prompt, tokens):
    """The JAX package's serial logits for the token after prompt+tokens."""
    step = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    st = jlm.init_decode_state(jcfg, 1, 48, ctx, params=jp)
    logits, st = step(jp, st, np.asarray([prompt], np.int32))
    for tok in tokens:
        logits, st = step(jp, st, np.asarray([[tok]], np.int32))
    return np.asarray(logits[0, -1])[:jcfg.vocab_size]


def test_engines_agree_on_a_port_artifact(artifact):
    """The reference's engine on the artifact it loaded and the port's on
    the same files: the same tokens, up to C2's exact ties."""
    cfg, _, path = artifact
    jcfg = jconfigs.get_smoke_config(ARCH)
    ctx = dataclasses.replace(default_ctx(), quantized_kv=True)
    jp = jckpt.load_artifact(path).params
    tp = ckpt.load_artifact(path, device="cpu").params
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (9, 14, 5)]
    jres = JEngine(jp, jcfg, ctx=ctx, n_slots=2, max_seq=48).run(
        [JRequest(prompt=p, max_new_tokens=8) for p in prompts])
    tres = Engine(tp, cfg, n_slots=2, max_seq=48, quantized_kv=True,
                  device="cpu").run(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
    compared = 0
    for i, prompt in enumerate(prompts):
        got, want = tres[i].tokens, jres[i].tokens
        n = next((t for t in range(len(want)) if got[t] != want[t]),
                 len(want))
        compared += n
        if n < len(want):
            ref = _reference_logits(jp, jcfg, ctx, prompt, want[:n])
            assert ref.argmax() == want[n]
            assert ref[got[n]] == ref.max(), (i, n)      # an exact tie
    assert compared >= 16


def test_save_artifact_refuses_ragged_widths(tmp_path):
    """A per-layer cut (layer 0 keeps 120 FFN columns, layer 1 all 128) has
    no stacked layout: ``save_artifact`` raises and writes nothing."""
    cfg = configs.get_smoke_config(ARCH)
    params = lm.init_params(cfg, seed=0, device="cpu")
    spec = next(s for s in sens.lm_prune_groups(cfg) if s.name == "L0/ffn")
    cut = sens.compact_group(params, spec, np.arange(8, cfg.d_ff))
    art = dataclasses.replace(
        compress(params, cfg, sq_grads=tree.map_(torch.ones_like, params),
                 eval_fn=lambda p: 1.0,
                 hqp=pipe.HQPConfig(max_steps=0), log=lambda s: None),
        params=quantize_lm_params(cut))
    assert pr.param_bytes(cut) < pr.param_bytes(params)
    with pytest.raises(ValueError, match="ragged"):
        ckpt.save_artifact(str(tmp_path / "artifact"), art)
    assert not (tmp_path / "artifact").exists()
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]


# ------------------------------------------------------------------ launcher
def _train(args, tmp_path, capsys):
    train_launcher.main(["--smoke", "--device", "cpu", "--batch", "4",
                         "--seq", "16", "--ckpt-dir", str(tmp_path),
                         *args])
    return capsys.readouterr().out


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    out = _train(["--steps", "4", "--ckpt-every", "2", "--eval-every", "2",
                  "--state-dtype", "int8", "--microbatches", "2"],
                 tmp_path, capsys)
    assert "next-token-acc" in out and "checkpointed" in out
    assert ckpt.latest_step(str(tmp_path)) == 4
    out = _train(["--steps", "6", "--ckpt-every", "2", "--state-dtype",
                  "int8", "--microbatches", "2"], tmp_path, capsys)
    assert "resumed from step 4" in out and "step_000000006" in out
    assert "[train] step 0 " not in out
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_train_launcher_sigterm_checkpoints_and_exits_143(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "1000000", "--batch", "2", "--seq",
         "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1000000",
         "--eval-every", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    try:
        for line in proc.stdout:
            if line.startswith("[train] step 10 "):
                break
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
    finally:
        proc.kill()
    assert proc.returncode == 143, out
    assert "preemption signal" in out
    step = ckpt.latest_step(str(tmp_path))
    assert step is not None and step > 10


def test_new_entry_points_default_to_the_card(artifact, tmp_path,
                                              monkeypatch):
    """device=None means CUDA: without a card the launcher, the quickstart
    and the artifact reader raise instead of running on the CPU."""
    from repro_torch.launch import quickstart
    _, _, path = artifact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launcher.main(["--smoke", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.load_artifact(path)
    assert not os.listdir(tmp_path)
