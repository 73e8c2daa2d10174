"""The hybrid family (jamba) in the port's model and weight bridge, on the
CPU, held against the JAX package on the same weights: the period of the
layer pattern; the train-route forward and the decode steps of the smoke
config (MoE allowance: ``_torch_hybrid_common``); the port's decode ==
prefill == whole prompt, bit for bit, through the whole model; fault C9 at
the model's serial decode; and the weight bridge at period 2 with 2
groups, both ways."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_hybrid_common import (ARCH, DEEP, assert_close_moe,  # noqa: E402,F401
                                  assert_greedy, assert_same_params, f32,
                                  jforward, make, one_thread)
from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import serial_decode as jserial  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import (QuantizedLinear,  # noqa: E402
                                  quantize_lm_params)
from repro_torch.configs.jamba_1_5_large import _pattern  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.weights import block_period, stack_blocks  # noqa: E402


@pytest.fixture(scope="module")
def base():
    """The smoke config (period 2, one group: mamba + dense MLP, then
    attention + MoE), the reference's seed-0 params and the port's copy."""
    return make()


# ------------------------------------------------------------------ pattern
@pytest.mark.parametrize("over, period", [({}, 2), (DEEP, 2), ("full", 8),
                                          ("cut5", 5), ("cut1", 1)],
                         ids=["smoke", "deep", "full", "cut5", "cut1"])
def test_pattern_period_equals_reference(over, period):
    """The period the JAX package stacks by, and each layer's (kind, MoE),
    at the smoke config, period 2 with 2 groups, the published 72 layers
    (period 8) and the card's cuts to 5 and 1 layers."""
    if over == "full":
        jcfg, cfg = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    elif isinstance(over, str):
        n = int(over[3:])
        cut = dict(n_layers=n, block_pattern=_pattern(n))
        jcfg = dataclasses.replace(jconfigs.get_config(ARCH), **cut)
        cfg = dataclasses.replace(configs.get_config(ARCH), **cut)
    else:
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **over)
        cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    assert lm.pattern_period(cfg) == jlm.pattern_period(jcfg)
    assert lm.layer_specs(cfg) == jlm.layer_specs(jcfg)
    assert lm.pattern_period(cfg) == period


def test_unported_block_kinds_are_refused():
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              block_pattern=("retnet", "attn"))
    with pytest.raises(NotImplementedError, match="retnet"):
        lm.init_params(cfg, device="cpu")


def _same_tree(a, b):
    if isinstance(a, QuantizedLinear):
        assert isinstance(b, QuantizedLinear) and a.bits == b.bits
        return _same_tree(a.w_q, b.w_q) and _same_tree(a.scale, b.scale)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_tree(a[k], b[k])
                                              for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("over", [{}, DEEP], ids=["smoke", "deep"])
def test_quantized_init_is_ptq_of_the_init(over):
    """``init_params(quantized=True)`` quantizes each layer as it is drawn:
    the tree and bits of ``quantize_lm_params`` of the bf16 init. The
    stacking period read off its layers is the config's, and a Mamba layer
    makes the pattern recurrent."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    q = lm.init_params(cfg, seed=2, device="cpu", quantized=True)
    assert _same_tree(q, quantize_lm_params(
        lm.init_params(cfg, seed=2, device="cpu")))
    assert block_period(q["blocks"]) == lm.pattern_period(cfg) == 2
    assert lm.is_recurrent(cfg)
    assert not lm.is_recurrent(configs.get_smoke_config("qwen3-0.6b"))


# ------------------------------------------------------------------ model
def test_forward_matches_reference(base):
    """The train route's final hidden states and logits (the Mamba layer
    from zero state, the MoE layer's experts)."""
    cfg, jcfg = base["cfg"], base["jcfg"]
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 16))
    hj = jforward(base["jp"], jcfg, toks)
    ht = lm.forward(base["tp"], cfg, {"tokens": torch.from_numpy(toks)})
    assert_close_moe(f32(ht), f32(hj))
    lj = jlm.logits_fn(base["jp"], jcfg, hj)
    lt = lm.logits_fn(base["tp"], cfg, ht, batch_invariant=False)
    real = slice(0, cfg.vocab_size)
    assert_close_moe(f32(lt)[..., real], f32(lj)[..., real])


def test_decode_steps_match_reference(base):
    """An 11-token prefill, then 8 decode steps fed the reference's greedy
    tokens: the logits with the MoE allowance, the greedy token wherever
    the reference's top-2 gap exceeds TIE_GAP."""
    cfg, jcfg, ctx = base["cfg"], base["jcfg"], base["ctx"]
    jstep = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 11))
    jst = jlm.init_decode_state(jcfg, 2, 32, ctx, params=base["jp"])
    tst = lm.init_decode_state(cfg, 2, 32, params=base["tp"], device="cpu")
    jtok, ttok = jnp.asarray(prompt, jnp.int32), torch.from_numpy(prompt)
    real = slice(0, cfg.vocab_size)
    for step in range(9):
        jl, jst = jstep(base["jp"], jst, jtok)
        tl, tst = lm.decode_step(base["tp"], cfg, tst, ttok,
                                 route="prefill" if step == 0 else "decode")
        a, b = np.asarray(jl[:, -1])[:, real], tl[:, 0].numpy()[:, real]
        assert_close_moe(b, a)
        assert_greedy(b, a, f"step {step}")
        nxt = a.argmax(-1)[:, None]
        jtok, ttok = jnp.asarray(nxt, jnp.int32), torch.from_numpy(nxt)
    h = tst["caches"][0]["h"]
    np.testing.assert_allclose(f32(h), f32(jst["caches"][0]["h"][0]),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("cuts", [[14], [1] * 14, [5, 4, 5], [8, 1, 5]],
                         ids=["whole", "decode", "5-4-5", "8-1-5"])
def test_cached_routes_give_the_same_bits(base, cuts):
    """Through the whole model (Mamba, attention, MoE): a 14-token prompt
    cut into chunks on the prefill route, or fed a token at a time on the
    decode route, gives the last position's logits and every layer's
    recurrent state of the whole prompt, bit for bit."""
    cfg, tp = base["cfg"], base["tp"]
    toks = torch.from_numpy(
        np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 14)))

    def run(cuts):
        st = lm.init_decode_state(cfg, 2, 32, params=tp, device="cpu")
        lo = 0
        for n in cuts:
            logits, st = lm.decode_step(
                tp, cfg, st, toks[:, lo:lo + n],
                route="decode" if n == 1 else "prefill")
            lo += n
        return logits, st

    want_l, want_st = run([14])
    got_l, got_st = run(cuts)
    assert torch.equal(got_l, want_l)
    for kind, a, b in zip(cfg.pattern, got_st["caches"], want_st["caches"]):
        if kind == "mamba":
            assert torch.equal(a["h"], b["h"]) and torch.equal(a["conv"],
                                                               b["conv"])


def test_c9_serial_decode_reference_raises(base):
    """Fault C9 at the model: the reference's serial decode of a 40-token
    prompt raises at the smoke config's chunk of 32 (its whole-prompt
    prefill runs the chunked scan), while 32- and 64-token prefills run,
    and the port's prefill logits match them (MoE allowance, greedy where
    decided). The port's serial decode runs at 40 tokens."""
    cfg, jcfg, ctx = base["cfg"], base["jcfg"], base["ctx"]
    assert cfg.ssm.chunk == 32
    prompt = np.random.RandomState(6).randint(0, cfg.vocab_size, 64)
    with pytest.raises(AssertionError):
        jserial(base["jp"], jcfg, prompt[:40], 2, ctx, max_seq=80)
    for n in (32, 64):
        jl, _ = jlm.decode_step(
            base["jp"], jcfg, jlm.init_decode_state(jcfg, 1, 80, ctx),
            jnp.asarray(prompt[None, :n], jnp.int32), ctx)
        tl, _ = lm.decode_step(
            base["tp"], cfg, lm.init_decode_state(cfg, 1, 80, device="cpu"),
            torch.from_numpy(prompt[None, :n]), route="prefill")
        a = np.asarray(jl[:, -1])[:, :cfg.vocab_size]
        b = tl[:, 0].numpy()[:, :cfg.vocab_size]
        assert_close_moe(b, a)
        assert_greedy(b, a, f"{n} tokens")
    out = serial_decode(base["tp"], cfg, prompt[:40].tolist(), 4,
                        max_seq=80, device="cpu")
    assert len(out) == 4 and all(0 <= t < cfg.vocab_size for t in out)


# ------------------------------------------------------------------ bridge
def test_weight_bridge_period_2_both_ways():
    """``from_jax_params`` reads layer g·2 + j from ``blocks[j][g]``, and
    ``stack_blocks`` writes it back there: the JAX tree's structure (a
    2-tuple) and every leaf's bits. A model the port initialised, stacked,
    runs in the JAX package and gives the port's hidden states."""
    deep = make(**DEEP)
    cfg, jcfg = deep["cfg"], deep["jcfg"]
    assert_same_params(deep["tp"], deep["jp"], 2)
    back = stack_blocks(deep["tp"])
    assert isinstance(back["blocks"], tuple) and len(back["blocks"]) == 2
    for j in range(2):
        flat_t = jax.tree_util.tree_leaves(
            jax.tree.map(f32, back["blocks"][j]))
        flat_j = jax.tree_util.tree_leaves(
            jax.tree.map(f32, deep["jp"]["blocks"][j]))
        assert len(flat_t) == len(flat_j)
        for a, b in zip(flat_t, flat_j):
            np.testing.assert_array_equal(a, b)
    own = lm.init_params(cfg, seed=3, device="cpu")
    stacked = stack_blocks(own)
    jp = jax.tree.map(lambda t: jnp.asarray(f32(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), stacked)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 12))
    assert_close_moe(f32(lm.forward(own, cfg,
                                    {"tokens": torch.from_numpy(toks)})),
                     f32(jforward(jp, jcfg, toks)))
