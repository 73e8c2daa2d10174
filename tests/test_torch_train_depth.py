"""Why xlstm-1.3b learns late at its published depth, in both packages: the
same model at the published 48 layers, 7:1 pattern and vocab, narrowed to
the smoke config's widths (d_model 64, 2 heads, chunk 32), from the same
init, trained STEPS steps on the quickstart's corpus (``DATA_VOCAB``
tokens) with the launcher's AdamW (lr 3e-3, clip 1, eps 1e-8), beside the
same model at 2 layers.

At 48 layers the first gradient's global norm is GROWN times the 2-layer
model's or more (it grows through the blocks), AdamW clips it to 1, and
more than half of the output table's clipped values fall under eps, where
the 2-layer model has under SHALLOW_UNDER there: over STEPS steps the
first batch's CE moves by less than STILL, in the port and in the
reference alike, where the 2-layer model lowers it by FALL or more. (At
its published width on the card the model leaves that phase after about
6 steps at lr 3e-3, and not within 10 at 3e-4: ``chip_smoke.py``'s
``FAMILY_TRAIN``.) Each side is held to these facts on its own: at 8
layers or more the CE is chaotic at the bf16 ulp (the reference's own
moves about as far from it as the port's when its embedding is scaled by
1 + 2^-8), so the trajectories are not compared step by step; one step is,
in ``test_torch_train_xlstm_step.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_train_common import ctx, one_thread  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.configs.xlstm_1_3b import _pattern  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.sensitivity import value_and_grad  # noqa: E402
from repro_torch.tree import leaves as tree_leaves  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.launch.quickstart import DATA_VOCAB  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "xlstm-1.3b"
STEPS, BATCH, SEQ, LR = 4, 4, 64, 3e-3
GROWN, STILL, FALL, SHALLOW_UNDER = 100.0, 5e-2, 1e-2, 5e-2


def _narrow(c, layers):
    full = c.get_config(ARCH)
    return dataclasses.replace(
        c.get_smoke_config(ARCH), vocab_size=full.vocab_size,
        n_layers=layers, block_pattern=_pattern(layers, 8),
        xlstm=dataclasses.replace(full.xlstm, chunk=32))


def _run(layers):
    """-> {side: (the first gradient's global norm, the share of its output
    table's values under eps once clipped, the per-step losses, the first
    batch's CE before and after)}."""
    jcfg, cfg = _narrow(jconfigs, layers), _narrow(configs, layers)
    it = SyntheticTokens(DATA_VOCAB, SEQ, BATCH * STEPS, seed=0,
                         determinism=0.9).batches(BATCH, seed=0)
    toks = [np.asarray(next(it)["tokens"]) for _ in range(STEPS)]
    host = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    # placed as the updates are, so that the step compiles once
    jp = jax.tree.map(jnp.asarray, host)
    tp = from_jax_params(host, device="cpu")
    ocfg, jocfg = opt.AdamWConfig(lr=LR), jopt.AdamWConfig(lr=LR)
    out = {}

    def stats(leaves, table):
        """(global norm, share of ``table`` under eps once clipped)"""
        norm = float(np.sqrt(sum(float(np.sum(np.square(a)))
                                 for a in leaves)))
        clip = min(1.0, ocfg.grad_clip / norm)
        return norm, float(np.mean(np.abs(table) * clip < ocfg.eps))

    # the reference's train step (``make_train_step`` at one microbatch:
    # the loss's gradient, then ``adamw_update``) with its gradient in view
    jvg = jax.jit(jax.value_and_grad(lambda p, t: jlm.loss_fn(
        p, jcfg, {"tokens": t}, ctx(False), with_aux=True)[0]))
    jupd = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jocfg))
    js, losses = jopt.adamw_init(jp, jocfg), []
    for t in toks + toks[:1]:       # the last: the first batch's loss after
        loss, jg = jvg(jp, jnp.asarray(t))
        if not losses:
            grad = stats(
                [np.asarray(a, np.float32) for a in jax.tree.leaves(jg)],
                np.asarray(jg["unembed"]["table"], np.float32))
        jp, js = jupd(jp, jg, js)
        losses.append(float(loss))
    out["reference"] = (*grad, losses[:-1], losses[0], losses[-1])

    g = value_and_grad(lambda p, b: lm.loss_fn(
        p, cfg, b, with_aux=True, moe_no_drop=False)[0])(
        tp, {"tokens": torch.as_tensor(toks[0])})[1]
    grad = stats([t.float().numpy() for t in tree_leaves(g)],
                 lm.unembed_params(g, cfg)["table"].float().numpy())
    step = make_train_step(cfg, ocfg, moe_no_drop=False)
    ts, losses = opt.adamw_init(tp, ocfg), []
    for t in toks + toks[:1]:
        tp, ts, m = step(tp, ts, {"tokens": torch.as_tensor(t)})
        losses.append(float(m["loss"]))
    out["port"] = (*grad, losses[:-1], losses[0], losses[-1])
    for side, (n, under, ls, b, a) in out.items():
        print(f"{layers} layers, {side}: first gradient norm {n:.6g}, "
              f"{under:.4f} of the output table's under eps once clipped; "
              f"losses "
              f"{[round(v, 4) for v in ls]}; first batch CE {b:.4f} -> "
              f"{a:.4f}")
    return out


@pytest.fixture(scope="module")
def shallow():
    return _run(2)


def test_two_layers_learn(shallow):
    for side, (_, under, _, before, after) in shallow.items():
        assert under < SHALLOW_UNDER and after <= (1 - FALL) * before, side


def test_published_depth_does_not_learn_in_either_package(shallow):
    deep = _run(48)
    for side in ("reference", "port"):
        norm, under, _, before, after = deep[side]
        assert norm >= GROWN * shallow[side][0], side
        assert under > 0.5 and abs(after - before) < STILL, side
