"""The xLSTM family (xlstm-1.3b) in the port's model and weight bridge on
the CPU, held against the JAX package on the same weights: the pattern's
period; the init's tree and its PTQ; the train-route forward and the
decode steps of the smoke config; the port's decode == prefill == whole
prompt, bit for bit, through the whole model; fault C10 at the model's
serial decode; and the bridge both ways at period 2 and period 8."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_xlstm_common import (ARCH, DEEP, LOGIT_ATOL,  # noqa: E402,F401
                                 PERIOD8, _jover, assert_close_system,
                                 assert_greedy, assert_same_params, f32,
                                 make, one_thread)
from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import (QuantizedLinear,  # noqa: E402
                                  quantize_lm_params)
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.weights import block_period, stack_blocks  # noqa: E402


@pytest.fixture(scope="module")
def base():
    """The smoke config (period 2, one group: mLSTM, then sLSTM), the
    reference's seed-0 params and the port's copy."""
    return make()


# ------------------------------------------------------------------ pattern
@pytest.mark.parametrize("over, period", [({}, 2), (DEEP, 2), (PERIOD8, 8),
                                          ("full", 8)],
                         ids=["smoke", "deep", "period8", "full"])
def test_pattern_period_equals_reference(over, period):
    """The period the JAX package stacks by, and each layer's kind, at the
    smoke config, period 2 with 2 groups, the published pattern at 8
    layers and at the published 48."""
    if over == "full":
        jcfg, cfg = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    else:
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                                   **_jover(over))
        cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    assert lm.pattern_period(cfg) == jlm.pattern_period(jcfg) == period
    assert lm.layer_specs(cfg) == jlm.layer_specs(jcfg)
    assert lm.is_recurrent(cfg)


def test_init_layout_and_ptq(base):
    """The port's own init has the reference's tree (an xLSTM layer is
    ``norm1`` and its block: no ``norm2``, no FFN); ``init_params(quantized
    =True)`` is the PTQ of the init, layer by layer; the PTQ quantizes the
    reference's linears (in_proj, out_proj, up, down) and leaves the
    per-head wq, wk, wv, the gates and the sLSTM's recurrent blocks in
    their precision; its stacking period is the config's."""
    cfg = base["cfg"]
    own = lm.init_params(cfg, seed=2, device="cpu")
    assert [sorted(b) for b in own["blocks"]] == [
        sorted(b) for b in base["tp"]["blocks"]] == [
        ["mlstm", "norm1"], ["norm1", "slstm"]]
    q = lm.init_params(cfg, seed=2, device="cpu", quantized=True)
    ptq = quantize_lm_params(own)
    for a, b in ((q, ptq),):
        ml, sl = a["blocks"][0]["mlstm"], a["blocks"][1]["slstm"]
        for lin in (ml["in_proj"], ml["out_proj"], sl["up"], sl["down"]):
            assert isinstance(lin, QuantizedLinear)
        for k in ("wq", "wk", "wv"):
            assert ml[k].dtype == torch.bfloat16
        assert ml["w_i"]["w"].dtype == torch.float32
        for g in "zifo":
            assert sl[f"w{g}"].dtype == sl[f"r{g}"].dtype == torch.float32
        assert torch.equal(ml["in_proj"].w_q, b["blocks"][0]["mlstm"][
            "in_proj"].w_q)
        assert torch.equal(sl["down"].scale, b["blocks"][1]["slstm"][
            "down"].scale)
    assert block_period(q["blocks"]) == lm.pattern_period(cfg) == 2


# ------------------------------------------------------------------ model
def test_forward_matches_reference(base):
    """The train route's final hidden states and logits (the mLSTM in its
    chunkwise form, the sLSTM stepped), within the reference's own
    chunkwise-versus-stepped rule."""
    cfg, jcfg = base["cfg"], base["jcfg"]
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 40))
    hj = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t})[0])(
        base["jp"], jnp.asarray(toks[:, :32]))
    ht = lm.forward(base["tp"], cfg, {"tokens": torch.from_numpy(toks)})
    assert ht.shape == (2, 40, cfg.d_model)
    assert_close_system(f32(ht[:, :32]), f32(hj))
    lj = jlm.logits_fn(base["jp"], jcfg, hj)
    lt = lm.logits_fn(base["tp"], cfg, ht[:, :32], batch_invariant=False)
    real = slice(0, cfg.vocab_size)
    assert_close_system(f32(lt)[..., real], f32(lj)[..., real])


@pytest.mark.parametrize("over", [{}, DEEP], ids=["smoke", "deep"])
def test_decode_steps_match_reference(over):
    """An 11-token prefill, then 8 decode steps fed the reference's greedy
    tokens: the prefill's logits within the reference's own rule, every
    decode step's within LOGIT_ATOL, the greedy token wherever decided;
    then the first layer's mLSTM state within f32 rounding of the
    reference's (its inputs are the same embeddings in both; a deeper
    layer's inputs carry the gap between the two prefill forms)."""
    d = make(**over)
    cfg, jcfg, ctx = d["cfg"], d["jcfg"], d["ctx"]
    jstep = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 11))
    jst = jlm.init_decode_state(jcfg, 2, 32, ctx, params=d["jp"])
    tst = lm.init_decode_state(cfg, 2, 32, params=d["tp"], device="cpu")
    jtok, ttok = jnp.asarray(prompt, jnp.int32), torch.from_numpy(prompt)
    real = slice(0, cfg.vocab_size)
    for step in range(9):
        jl, jst = jstep(d["jp"], jst, jtok)
        tl, tst = lm.decode_step(d["tp"], cfg, tst, ttok,
                                 route="prefill" if step == 0 else "decode")
        a, b = np.asarray(jl[:, -1])[:, real], tl[:, 0].numpy()[:, real]
        if step == 0:
            assert_close_system(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"step {step}")
            assert_greedy(b, a, f"step {step}")
        nxt = a.argmax(-1)[:, None]
        jtok, ttok = jnp.asarray(nxt, jnp.int32), torch.from_numpy(nxt)
    for k, leaf in zip(("C", "n", "m"), jst["caches"][0]):
        want = f32(leaf[0])
        np.testing.assert_allclose(f32(tst["caches"][0][k]), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("cuts", [[14], [1] * 14, [5, 4, 5], [8, 1, 5]],
                         ids=["whole", "decode", "5-4-5", "8-1-5"])
def test_cached_routes_give_the_same_bits(base, cuts):
    """Through the whole model: a 14-token prompt cut into chunks on the
    prefill route, or fed a token at a time on the decode route, gives the
    last position's logits and every layer's state of the whole prompt,
    bit for bit."""
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
    for a, b in zip(got_st["caches"], want_st["caches"]):
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_c10_serial_decode_reference_raises(base):
    """Fault C10 at the model: the reference's serial decode of a 40-token
    prompt raises at the smoke config's chunk of 32 (its whole-prompt
    prefill runs the chunkwise mLSTM), while 32- and 64-token prompts run,
    and the port's prefill logits match them within the reference's own
    rule, greedy where decided. The port's serial decode runs at 40."""
    cfg, jcfg, ctx = base["cfg"], base["jcfg"], base["ctx"]
    assert cfg.xlstm.chunk == 32
    prompt = np.random.RandomState(6).randint(0, cfg.vocab_size, 64)
    with pytest.raises(AssertionError):
        jengine.serial_decode(base["jp"], jcfg, prompt[:40].tolist(), 3,
                              ctx, max_seq=128)
    for n in (32, 64):
        jl, _ = jlm.decode_step(
            base["jp"], jcfg, jlm.init_decode_state(jcfg, 1, 128, ctx),
            jnp.asarray(prompt[None, :n], jnp.int32), ctx)
        tl, _ = lm.decode_step(
            base["tp"], cfg, lm.init_decode_state(cfg, 1, 128, device="cpu"),
            torch.from_numpy(prompt[None, :n]), route="prefill")
        a = np.asarray(jl[:, -1])[:, :cfg.vocab_size]
        b = tl[:, 0].numpy()[:, :cfg.vocab_size]
        assert_close_system(b, a)
        assert_greedy(b, a, f"{n} tokens")
    out = serial_decode(base["tp"], cfg, prompt[:40].tolist(), 3,
                        max_seq=128, device="cpu")
    assert len(out) == 3 and all(0 <= t < cfg.vocab_size for t in out)


# ------------------------------------------------------------------ bridge
@pytest.mark.parametrize("over, period", [(DEEP, 2), (PERIOD8, 8)],
                         ids=["period2", "period8"])
def test_weight_bridge_both_ways(over, period):
    """``from_jax_params`` reads layer g·P + j from ``blocks[j][g]`` (the
    mLSTM's stacked (G, h, hd, hd) wq/wk/wv, its gates and norm, the
    sLSTM's bare w*/r* arrays and biases), and ``stack_blocks`` writes it
    back there: the JAX tree's structure (a P-tuple) and every leaf's
    bits. A model the port initialised, stacked, runs in the JAX package's
    decode steps and gives the port's logits within the reference's own
    rule (the decode route: on the train route, random weights through 8
    layers amplify a rounding until the reference's own two forms break
    that rule)."""
    d = make(**over)
    cfg, jcfg = d["cfg"], d["jcfg"]
    assert block_period(d["tp"]["blocks"]) == period
    assert_same_params(d["tp"], d["jp"], period)
    back = stack_blocks(d["tp"])
    assert isinstance(back["blocks"], tuple) and len(back["blocks"]) == period
    for j in range(period):
        flat_t = jax.tree_util.tree_leaves(
            jax.tree.map(f32, back["blocks"][j]))
        flat_j = jax.tree_util.tree_leaves(
            jax.tree.map(f32, d["jp"]["blocks"][j]))
        assert len(flat_t) == len(flat_j)
        for a, b in zip(flat_t, flat_j):
            np.testing.assert_array_equal(a, b)
    own = lm.init_params(cfg, seed=3, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(f32(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32),
        stack_blocks(own))
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 6))
    ctx = d["ctx"]
    jstep = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    jst = jlm.init_decode_state(jcfg, 2, 32, ctx, params=jp)
    tst = lm.init_decode_state(cfg, 2, 32, params=own, device="cpu")
    for t in range(toks.shape[1]):
        jl, jst = jstep(jp, jst, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, tst = lm.decode_step(own, cfg, tst,
                                 torch.from_numpy(toks[:, t:t + 1]),
                                 route="decode")
        assert_close_system(f32(tl), f32(jl))
