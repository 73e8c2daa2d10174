"""The MoE family through the port's model on the CPU, held against the
JAX package on the phi3.5-moe and arctic smoke configs, same weights
(``from_jax_params``): the train-route forward and loss, and the decode
step of the bf16 model and of an HQP artifact that the JAX package
compressed and saved and the port loaded. Tolerances and the routing
allowance: ``_torch_moe_common``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_moe_common import (HIDDEN, LOGIT_ATOL,  # noqa: E402,F401
                               assert_close_moe, assert_greedy,
                               assert_same_params, base, f32, jforward,
                               one_thread)
from repro.compress import compress as jcompress  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.launch import checkpoint as jckpt  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.launch import checkpoint as ckpt  # noqa: E402
from repro_torch.models import lm  # noqa: E402

N_STEPS = 8


@pytest.fixture(scope="module")
def hqp(base, tmp_path_factory):
    """An HQP artifact the reference compressed (|w| as the squared grads,
    two steps of 10 %), its params, and the port's load of it."""
    jp = base["jp"]
    art = jcompress(jp, base["jcfg"], log=lambda s: None,
                    sq_grads=jax.tree.map(
                        lambda t: jnp.abs(t.astype(jnp.float32)), jp),
                    eval_fn=lambda p: 1.0,
                    hqp=jpipe.HQPConfig(weight_granularity="channel",
                                        step_frac=0.1, max_steps=2))
    assert art.manifest.pruned and art.manifest.n_drop > 0
    art_dir = str(tmp_path_factory.mktemp("hqp") / "artifact")
    jckpt.save_artifact(art_dir, art)
    return art.params, ckpt.load_artifact(art_dir, device="cpu")


def test_forward_and_loss_match_reference(base):
    h = lm.forward(base["tp"], base["cfg"], base["tb"])
    hj = jforward(base["jp"], base["jcfg"], base["jb"]["tokens"])
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == hj.shape
    assert_close_moe(f32(h), f32(hj), **HIDDEN)
    loss = lm.loss_fn(base["tp"], base["cfg"], base["tb"])
    lj, _ = jlm.loss_fn(base["jp"], base["jcfg"], base["jb"], base["ctx"],
                        with_aux=False)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-4)


@pytest.mark.parametrize("kind", ["fp", "hqp"])
def test_decode_matches_reference(base, hqp, kind):
    """Prompt prefill plus N_STEPS greedy decode steps fed the reference's
    tokens, bf16 KV for the bf16 model and INT8 KV for the artifact."""
    jcfg, cfg = base["jcfg"], base["cfg"]
    jp, tp = ((base["jp"], base["tp"]) if kind == "fp"
              else (hqp[0], hqp[1].params))
    qkv = kind == "hqp"
    ctx = dataclasses.replace(base["ctx"], quantized_kv=qkv)
    jstep = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 11))
    jst = jlm.init_decode_state(jcfg, 2, 32, ctx, params=jp)
    tst = lm.init_decode_state(cfg, 2, 32, params=tp, quantized_kv=qkv,
                               device="cpu")
    jtok, ttok = jnp.asarray(prompt, jnp.int32), torch.from_numpy(prompt)
    real = slice(0, cfg.vocab_size)
    got, want = [], []
    for step in range(N_STEPS + 1):
        jl, jst = jstep(jp, jst, jtok)
        tl, tst = lm.decode_step(tp, cfg, tst, ttok,
                                 route="prefill" if step == 0 else "decode")
        a, b = np.asarray(jl[:, -1])[:, real], tl[:, 0].numpy()[:, real]
        assert (tl[:, 0, cfg.vocab_size:] == -1e30).all()
        assert_greedy(b, a, f"step {step}")
        want.append(a)
        got.append(b)
        nxt = a.argmax(-1)[:, None]
        jtok, ttok = jnp.asarray(nxt, jnp.int32), torch.from_numpy(nxt)
    assert_close_moe(np.stack(got), np.stack(want), 0, LOGIT_ATOL)


def test_reference_artifact_loads_into_the_port(base, hqp):
    """The reference's MoE artifact loaded by the port: the JAX layout's
    stacked expert leaves (L, E, K, N) and scales (L, E, N) split per layer,
    every array equal."""
    jparams, tart = hqp
    assert tart.manifest.arch == base["cfg"].name
    q = tart.params["blocks"][0]["moe"]["gate"]
    e = jparams["blocks"][0]["moe"]["gate"].w_q.shape[1]
    assert isinstance(q, QuantizedLinear) and q.w_q.shape[0] == e
    assert q.scale.shape == (e, base["cfg"].d_ff)
    assert_same_params(tart.params, jparams)
