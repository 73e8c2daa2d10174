"""The frontend configs' model (phi-3-vision-4.2b, musicgen-medium) held
against the JAX package on their smoke configs, same weights (carried
across by ``from_jax_params``, the top-level ``frontend`` linear
included) and the same seeded random embeddings: the train-route forward
with the embeddings prepended, the loss over the text positions and its
gradient leaf by leaf, the eval step's accuracy, and a prefill that
prepends the embeddings followed by decode steps, in bf16 and INT8 PTQ
params, bf16 and INT8 KV. Also: drawing a frontend leaves every other
seed-0 leaf as it was. Tolerances in ``_torch_frontend_common``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_frontend_common import (ARCHS, HIDDEN, LOGIT_ATOL,  # noqa: E402,F401
                                    assert_tree_same, batches, embeds, f32,
                                    make, np_tree, one_thread)
from _torch_train_common import check_loss  # noqa: E402
from repro.compress.quantize import quantize_lm_params as jquantize  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train.train_step import make_eval_step as jmake_eval  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import QuantizedLinear, quantize_lm_params  # noqa: E402
from repro_torch.configs.base import FrontendConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.train_step import make_eval_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N_STEPS = 8


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return make(request.param)


def test_forward_prepends_the_mapped_embeddings(model):
    """(B, n_fr + S, d) hidden states within HIDDEN of the reference's;
    the embeddings move every position (the frontend linear is live)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 16))
    jb, tb = batches(toks, embeds(cfg, 2, 5))
    hj = jax.jit(lambda p, b: jlm.forward(p, jcfg, b)[0])(model["jp"], jb)
    ht = lm.forward(model["tp"], cfg, tb)
    assert ht.shape == (2, cfg.frontend.n_embeds + 16, cfg.d_model)
    np.testing.assert_allclose(f32(ht), f32(hj), **HIDDEN)
    other = lm.forward(model["tp"], cfg, dict(tb, embeds=tb["embeds"] * 2))
    assert not torch.equal(other[:, -1], ht[:, -1])


def test_loss_and_every_gradient_leaf(model):
    """``loss_fn`` over the text positions (hidden n_fr + i predicts token
    i + 1) within the train files' LOSS_RTOL, and every gradient leaf,
    ``frontend/w`` included, within 5 % of its norm
    (``_torch_train_common.check_leaves``)."""
    cfg = model["cfg"]
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 32))
    check_loss(dict(model, tokens=toks, embeds=embeds(cfg, 2, 6)), True)


def test_eval_step_skips_the_frontend_positions(model):
    """The next-token accuracy of the eval step equals the reference's on
    a batch the model predicts in part (its own greedy continuations)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    emb = embeds(cfg, 2, 7)
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 24))
    n_fr = cfg.frontend.n_embeds
    for i in range(1, 13):              # tokens 1-12 follow the model
        hid = lm.forward(model["tp"], cfg, batches(toks, emb)[1])
        toks[:, i] = lm.logits_fn(model["tp"], cfg,
                                  hid[:, n_fr + i - 1]).argmax(-1).numpy()
    jb, tb = batches(toks, emb)
    acc = float(make_eval_step(cfg)(model["tp"], tb))
    assert acc == float(jax.jit(jmake_eval(jcfg, model["ctx"]))(
        model["jp"], jb))
    assert acc >= 12 / 23 - 2 / 23


def test_init_leaves_every_other_leaf_unchanged():
    """A frontend config's seed-0 tree, outside ``frontend``, equals the
    tree of the same config without a frontend, bit for bit (so no
    earlier config's seed-0 params moved); with ``quantized`` the
    frontend is the PTQ of the bf16 one."""
    for arch in ARCHS:
        cfg = configs.get_smoke_config(arch)
        with_fr = lm.init_params(cfg, seed=0, device="cpu")
        without = lm.init_params(dataclasses.replace(
            cfg, frontend=FrontendConfig()), seed=0, device="cpu")
        assert list(with_fr) == ["embed", "unembed", "frontend", "blocks",
                                 "final_norm"]
        assert "frontend" not in without
        assert with_fr["frontend"]["w"].shape == (cfg.d_model, cfg.d_model)
        rest = {k: v for k, v in with_fr.items() if k != "frontend"}
        flat_a, flat_b = _flat(rest), _flat(without)
        assert sorted(flat_a) == sorted(flat_b)
        for k in flat_a:
            assert torch.equal(flat_a[k], flat_b[k]), k
        q = lm.init_params(cfg, seed=0, device="cpu", quantized=True)
        want = quantize_lm_params(with_fr)["frontend"]
        assert isinstance(q["frontend"], QuantizedLinear)
        assert torch.equal(q["frontend"].w_q, want.w_q)
        assert torch.equal(q["frontend"].scale, want.scale)


def _flat(t, path=""):
    if isinstance(t, dict):
        return {k: v for key, sub in t.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(t, (list, tuple)):
        return {k: v for i, sub in enumerate(t)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: t}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "ptq"])
@pytest.mark.parametrize("quantized_kv", [False, True], ids=["kv16", "kv8"])
def test_prefill_with_embeds_then_decode(model, int8, quantized_kv):
    """A prefill of the embeddings and an 11-token prompt, then N_STEPS
    decode steps fed the reference's tokens: the logits within LOGIT_ATOL
    at every step, the greedy token wherever the reference's top-2 gap
    exceeds twice that, and ``pos`` past the frontend's positions. With
    ``int8`` the port serves the reference's PTQ (the frontend's codes
    included), carried across by ``from_jax_params``; its own PTQ of the
    same weights holds those codes within ROADMAP C1.

    With bf16 KV the reference runs compiled, its decode step under
    ``jax.jit`` as its launcher runs it. With INT8 KV it runs eagerly
    (``jax.disable_jit``), as the port computes: compiled, it moves the
    second layer's INT8 KV codes by up to 7 steps against its own eager
    blocks, and the logits up to 0.0215 from the port's (ROADMAP C16)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    jp, tp = model["jp"], model["tp"]
    if int8:
        jp = jquantize(jp)
        assert_tree_same(quantize_lm_params(tp), jp, c1=True)
        tp = from_jax_params(np_tree(jp), device="cpu")
        assert isinstance(tp["frontend"], QuantizedLinear)
    ctx = dataclasses.replace(model["ctx"], quantized_kv=quantized_kv)
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 11))
    jb, tb = batches(prompt, embeds(cfg, 2, 8))
    n_fr = cfg.frontend.n_embeds
    tst = lm.init_decode_state(cfg, 2, 48, params=tp,
                               quantized_kv=quantized_kv, device="cpu")
    tl, tst = lm.decode_step(tp, cfg, tst, tb["tokens"], route="prefill",
                             embeds=tb["embeds"])
    if quantized_kv:
        def jstep(p, st, tok, *emb):
            with jax.disable_jit():
                return jlm.decode_step(p, jcfg, st, tok, ctx, *emb)
    else:
        jstep = jax.jit(lambda p, st, tok, *emb: jlm.decode_step(
            p, jcfg, st, tok, ctx, *emb))
    jst = jlm.init_decode_state(jcfg, 2, 48, ctx, params=jp)
    jl, jst = jstep(jp, jst, jb["tokens"], jb["embeds"])
    assert tst["pos"] == int(jst["pos"]) == n_fr + 11
    real = slice(0, cfg.vocab_size)
    for step in range(N_STEPS + 1):
        if step:
            jl, jst = jstep(jp, jst, jtok)
            tl, tst = lm.decode_step(tp, cfg, tst, ttok, route="decode")
        a, b = np.asarray(jl[:, -1])[:, real], tl[:, 0].numpy()[:, real]
        np.testing.assert_allclose(b, a, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
        top2 = np.sort(a, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
        np.testing.assert_array_equal(b.argmax(-1)[decided],
                                      a.argmax(-1)[decided])
        nxt = a.argmax(-1)[:, None]
        jtok, ttok = jnp.asarray(nxt, jnp.int32), torch.from_numpy(nxt)
    assert tst["pos"] == n_fr + 11 + N_STEPS
