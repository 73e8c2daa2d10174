"""What the frontend test files share: the two frontend configs
(phi-3-vision-4.2b, musicgen-medium) at smoke size, both packages' seed-0
params (``make``), seeded random embeddings (the launchers' zeros would
leave the frontend linear untested), the reference's lockstep loop with
its top-2 gaps, and the tolerances.

Tolerances, those of ``test_torch_configs.py``: the train-route hidden
states within a bf16 ulp a layer (``HIDDEN``), the decode-step logits
within ``LOGIT_ATOL``, the greedy token wherever the reference's top-2 gap
exceeds twice that. A greedy token sequence (the launchers', an
artifact's) is held to the reference's up to its first near tie, a top-2
gap under ``TIE_GAP`` (ROADMAP C2: the logits are bf16 values one ulp
apart there, and an INT8 activation code one step off on either side
decides it). Integer results (Fisher ranks, masks, the history) are
exact; INT8 codes and scales of the two packages' PTQ are held to ROADMAP
C1 (the jitted reference divides by 127 through a reciprocal:
``_torch_hybrid_common.assert_same_params``, here with the top-level
``frontend`` linear under the same rule as the blocks' linears).

A test file imports the fixtures it uses (``one_thread``) so that pytest
finds them in its namespace."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_hybrid_common import (C1_CODES, assert_same_params,  # noqa: F401
                                  f32, np_tree, one_thread)

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.sharding.ctx import default_ctx
from repro_torch import configs
from repro_torch.compress import QuantizedLinear
from repro_torch.weights import from_jax_params

ARCHS = ("phi-3-vision-4.2b", "musicgen-medium")
HIDDEN = dict(rtol=2 ** -7, atol=6.25e-2)
LOGIT_ATOL = 2e-2
TIE_GAP = 2e-2


def make(arch: str) -> dict:
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, ctx=default_ctx(), jp=jp,
                tp=from_jax_params(np_tree(jp), device="cpu"))


def embeds(cfg, batch: int, seed: int) -> np.ndarray:
    """Seeded unit-normal embeddings (batch, n_fr, d_model), rounded to
    bf16 values (both packages cast them to bf16)."""
    e = np.random.RandomState(seed).randn(batch, cfg.frontend.n_embeds,
                                          cfg.d_model)
    return np.asarray(jnp.asarray(e, jnp.bfloat16).astype(jnp.float32))


def batches(tokens: np.ndarray, emb: np.ndarray):
    """The same (tokens, embeds) batch for the reference and the port."""
    return ({"tokens": jnp.asarray(tokens, jnp.int32),
             "embeds": jnp.asarray(emb, jnp.bfloat16)},
            {"tokens": torch.as_tensor(tokens),
             "embeds": torch.from_numpy(emb.copy()).to(torch.bfloat16)})


def assert_frontend_same(tp, jp, c1: bool = False) -> None:
    """Both trees' ``frontend`` linears equal: bits, or C1's one code step
    and one scale ulp for two packages' PTQ."""
    t, j = tp["frontend"], jp["frontend"]
    if not isinstance(t, QuantizedLinear):
        np.testing.assert_array_equal(f32(t["w"]), f32(j["w"]))
        return
    a, b = f32(t.w_q), f32(j.w_q)
    assert a.shape == b.shape
    if c1:
        assert (a != b).mean() <= C1_CODES and np.abs(a - b).max() <= 1
        np.testing.assert_allclose(f32(t.scale), f32(j.scale), rtol=2 ** -23,
                                   atol=0)
    else:
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(f32(t.scale), f32(j.scale))


def assert_tree_same(tp, jp, c1: bool = False) -> None:
    """``assert_same_params`` at period 1 (both configs are all-attention),
    the frontend held by ``assert_frontend_same``."""
    assert_frontend_same(tp, jp, c1)
    rest = lambda t: {k: v for k, v in t.items() if k != "frontend"}
    assert_same_params(rest(tp), rest(jp), 1, c1=c1)


def jlockstep(params, jcfg, ctx, batch: int, prompt_len: int, tokens: int,
              max_seq: int):
    """The reference launcher's lockstep loop (``repro.launch.serve``:
    prompts from ``RandomState(0)``, zero embeddings, greedy) on
    ``params``: (tokens (batch, tokens), the top-2 gap of the logits each
    token was picked from)."""
    st = jlm.init_decode_state(jcfg, batch, max_seq, ctx, params=params)
    prompts = jnp.asarray(np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (batch, prompt_len)), jnp.int32)
    emb = jnp.zeros((batch, jcfg.frontend.n_embeds, jcfg.d_model),
                    jnp.bfloat16)
    lg, st = jlm.decode_step(params, jcfg, st, prompts, ctx, emb)
    step = jax.jit(lambda p, s, t: jlm.decode_step(p, jcfg, s, t, ctx))
    out, gaps = [], []
    for i in range(tokens):
        lf = np.asarray(lg[:, -1].astype(jnp.float32))[:, :jcfg.vocab_size]
        top2 = np.sort(lf, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        out.append(lf.argmax(-1)[:, None])
        if i < tokens - 1:
            lg, st = step(params, st, jnp.asarray(out[-1], jnp.int32))
    return np.concatenate(out, 1), np.stack(gaps, 1)


def assert_tokens_to_first_tie(got: np.ndarray, want: np.ndarray,
                               gaps: np.ndarray) -> None:
    """Each row of ``got`` equals ``want``'s, or leaves it first at a
    near tie: a step whose top-2 gap lies under TIE_GAP (the tokens
    before it being equal, both packages decode from the same prefix
    there)."""
    assert got.shape == want.shape
    for r in range(want.shape[0]):
        off = np.nonzero(got[r] != want[r])[0]
        if len(off):
            assert gaps[r, off[0]] < TIE_GAP, (r, off[0], gaps[r, off[0]])
