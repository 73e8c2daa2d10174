"""Algorithm 1 deciding on a trained model, in both packages, on the CPU;
and the port's quickstart end to end.

The port trains the qwen3-0.6b smoke model on the quickstart's corpus until
it predicts the chain (the ceiling is 0.9), and the weights cross into the
JAX package through a port-written checkpoint. Both packages then run
``conditional_prune`` at the quickstart's Δ_ax 0.015, δ 5 %, with the same
squared gradients (the reference's Fisher diagonal over the quickstart's
four calibration batches) and each its own accuracy on the same validation
batches. Their histories must match step for step (``n_drop``, accept and
reject), and end in a REJECT.

Tolerance: an accuracy is a mean over 512 x 32 = 16,384 predictions, which
differ between the frameworks only where the logits hold a near tie (the
forwards round bf16 at their own places, ``test_torch_hqp.py``; at most 3
predictions apart at any step on this model): each step's accuracies within
EVAL_TOL = 5e-4 (8 predictions). A step whose drop lies within EVAL_TOL of
Δ_ax could be decided either way by that noise: the test then says so and
holds the steps before it only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.launch import checkpoint as jckpt  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro.train.train_step import make_eval_step as jmake_eval  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.launch import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import quickstart as qs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-0.6b"
TRAIN_STEPS = 80
EVAL_TOL = 5e-4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg = configs.get_smoke_config(ARCH)
    data, val = qs.corpus(cfg)
    params = lm.init_params(cfg, seed=0, device="cpu")
    ocfg = AdamWConfig(lr=qs.LR)
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg)
    for batch in qs.train_batches(data, TRAIN_STEPS, "cpu"):
        params, opt, _ = step(params, opt, batch)
    d = str(tmp_path_factory.mktemp("trained"))
    ckpt.save(d, TRAIN_STEPS, params)
    jcfg = jconfigs.get_smoke_config(ARCH)
    jp, meta = jckpt.restore(d, jlm.init_params(jax.random.PRNGKey(0), jcfg))
    assert meta["step"] == TRAIN_STEPS
    return cfg, jcfg, params, jp, data, val


def test_conditional_prune_decides_as_the_reference(trained):
    cfg, jcfg, tp, jp, data, val = trained
    ctx = default_ctx()
    grad = jax.jit(jax.grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b, ctx, with_aux=False)[0]))
    calib = [{"tokens": jnp.asarray(b["tokens"])}
             for b in data.batches(qs.BATCH)][:qs.N_CALIB]
    jsq, _ = jsens.fisher_diag(grad, jp, calib)
    tsq = from_jax_params(jax.tree.map(np.asarray, jsq), device="cpu")

    jeval = jax.jit(jmake_eval(jcfg, ctx))
    vb = [jnp.asarray(b["tokens"]) for b in val.batches(qs.BATCH)]
    jacc = lambda p: float(np.mean([float(jeval(p, {"tokens": t}))
                                    for t in vb]))
    hqp = qs.HQP
    jres = jpipe.conditional_prune(
        jp, jsens.lm_prune_groups(jcfg), jsq, jacc,
        jpipe.HQPConfig(delta_ax=hqp.delta_ax, step_frac=hqp.step_frac,
                        max_steps=hqp.max_steps),
        log=lambda s: None)
    tres = pipe.conditional_prune(tp, sens.lm_prune_groups(cfg), tsq,
                                  qs.accuracy_fn(cfg, val, "cpu"), hqp,
                                  log=print)

    assert tres.a_baseline >= 0.8, "the model did not learn the chain"
    assert abs(tres.a_baseline - jres.a_baseline) <= EVAL_TOL
    assert not jres.history[-1].accepted and not tres.history[-1].accepted
    assert all(h.accepted for h in tres.history[:-1])
    steps = len(jres.history)
    for t, h in enumerate(jres.history):
        if abs(h.drop - hqp.delta_ax) <= EVAL_TOL:
            print(f"step {h.step}: the reference's drop {h.drop:.4f} lies "
                  f"within {EVAL_TOL} of Δ_ax; only the steps before it are "
                  f"held")
            steps = t
            break
    assert steps >= 3
    for got, want in zip(tres.history[:steps], jres.history[:steps]):
        assert (got.step, got.n_drop, got.accepted) == (
            want.step, want.n_drop, want.accepted)
        assert abs(got.accuracy - want.accuracy) <= EVAL_TOL, got.step
    if steps == len(jres.history):
        assert len(tres.history) == steps
        assert (tres.n_drop, tres.theta) == (jres.n_drop, jres.theta)


def test_quickstart_smoke(capsys):
    """``python -m repro_torch.launch.quickstart --smoke --device cpu``
    with fewer training steps: it trains, decides, saves, loads and serves,
    and exits 0."""
    assert qs.main(["--smoke", "--device", "cpu", "--steps", "40"]) == 0
    out = capsys.readouterr().out
    steps = [ln for ln in out.splitlines() if ln.startswith("[hqp] step")]
    assert steps and all(("ACCEPT" in ln) != ("REJECT" in ln)
                         for ln in steps)
    assert "REJECT" in steps[-1]
    assert "engine == serial decode of the loaded and of the in-memory" in out
