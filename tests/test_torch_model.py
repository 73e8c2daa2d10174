"""The port's model layers, KV cache, decode step and weight loading, held
against the JAX package on the qwen3-0.6b smoke config, same weights.

Tolerances: the two frameworks round ``rsqrt`` in the norms, ``pow``/
``cos``/``sin`` in RoPE and the bf16 outputs of elementwise ops at their own
places, so a layer's bf16 output may sit one bf16 ulp away (rtol 2^-7).
One ulp in an activation can move an int8 activation code by one, so the
whole slice is held on its f32 logits (|logit| <~ 1 here) within LOGIT_ATOL
and on its greedy tokens, which must agree wherever the reference's choice
is decided: the logits are bf16 values, so the reference can hold an exact
tie (the HQP artifact under bf16 KV does, at decode step 14 of this
prompt), and a tie-break follows bits no other framework reproduces. There
the port must pick a token within 2 * LOGIT_ATOL of the reference's best.
What is integer-valued (INT8 KV codes and scales, quantized weights, a
quantized dense from identical inputs) must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compress import compress  # noqa: E402
from repro.compress import quantize as jq  # noqa: E402
from repro.core.pipeline import HQPConfig  # noqa: E402
from repro.launch.checkpoint import COMMIT_MARKER, save_artifact  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import (QuantizedLinear, linear_bytes,  # noqa: E402
                                   quantize_lm_params)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.launch.checkpoint import load_artifact  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-0.6b"
BF16_ULP = dict(rtol=2 ** -7, atol=1e-6)
LOGIT_ATOL = 2e-2
N_STEPS = 16


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX cfg, port cfg, {kind: (JAX params, port params)}) for the FP
    params and an HQP artifact pruned (2 conditional steps) and quantized by
    the JAX package, saved with ``save_artifact`` and loaded by the port."""
    cfg = jconfigs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(0), cfg)
    art = compress(jp, cfg, log=lambda s: None,
                   sq_grads=jax.tree.map(
                       lambda t: jnp.abs(t.astype(jnp.float32)), jp),
                   eval_fn=lambda p: 1.0,
                   hqp=HQPConfig(weight_granularity="channel", step_frac=0.1,
                                 max_steps=2))
    assert art.manifest.pruned and art.manifest.n_drop > 0
    art_dir = str(tmp_path_factory.mktemp("hqp") / "artifact")
    save_artifact(art_dir, art)
    loaded = load_artifact(art_dir, device="cpu")
    assert loaded.manifest.arch == cfg.name
    tp_art = loaded.params
    return cfg, configs.get_smoke_config(ARCH), {
        "fp": (jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                   device="cpu")),
        "hqp": (art.params, tp_art),
    }, art_dir


def _bf16(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------ layers
def test_layers_match_reference(models):
    cfg, tcfg, weights, _ = models
    jp, tp = weights["fp"]
    rng = np.random.RandomState(0)
    xj, xt = _bf16(rng.randn(2, 5, cfg.d_model))
    g = rng.rand(cfg.d_model).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        _f32(L.rmsnorm(xt, {"g": torch.from_numpy(g)})),
        _f32(JL.rmsnorm(xj, {"g": jnp.asarray(g)})), **BF16_ULP)
    hj, ht = _bf16(rng.randn(2, 5, 4, 16))
    np.testing.assert_allclose(_f32(L.l2norm(ht)), _f32(JL.l2norm(hj)),
                               **BF16_ULP)
    pos = np.array([[3, 4, 5, 6, 7], [40, 41, 42, 43, 44]])
    np.testing.assert_allclose(
        _f32(L.apply_rope(ht, torch.from_numpy(pos), 1e6)),
        _f32(JL.apply_rope(hj, jnp.asarray(pos), 1e6)), **BF16_ULP)
    blk_j = jax.tree.map(lambda t: t[0], jp["blocks"][0])
    np.testing.assert_allclose(_f32(L.mlp(xt, tp["blocks"][0]["mlp"])),
                               _f32(JL.mlp(xj, blk_j["mlp"])), **BF16_ULP)
    toks = rng.randint(0, cfg.vocab_size, (2, 5))
    np.testing.assert_array_equal(
        _f32(L.embed_lookup(tp["embed"], torch.from_numpy(toks))),
        _f32(JL.embed_lookup(jp["embed"], jnp.asarray(toks))))
    np.testing.assert_allclose(_f32(L.unembed(tp["embed"], xt)),
                               _f32(JL.unembed(jp["embed"], xj)),
                               rtol=2 ** -7, atol=1e-3)


def test_quantized_dense_equals_reference(models):
    """From identical bf16 inputs the W8A8 dense is exact: same codes, same
    int32 sums, same epilogue order."""
    _, _, weights, _ = models
    jp, tp = weights["hqp"]
    xj, xt = _bf16(np.random.RandomState(1).randn(3, 7, 64))
    wj = jax.tree.map(lambda t: t[0], jp["blocks"][0])["attn"]["wq"]
    wt = tp["blocks"][0]["attn"]["wq"]
    assert isinstance(wt, QuantizedLinear)
    np.testing.assert_array_equal(_f32(L.dense(xt, wt)),
                                  _f32(JL.dense(xj, wj)))
    assert linear_bytes(wt) == JL.linear_bytes(wj)
    assert L.out_features(wt) == JL.out_features(wj)


def test_quantize_lm_params_matches_reference(models):
    """INT8 codes and scales equal the JAX package's symmetric quantizer run
    eagerly (under ``jit`` XLA divides by 127 through a multiply by
    fl(1/127); see test_torch_kernels)."""
    _, _, weights, _ = models
    jp, tp = weights["fp"]
    tq = quantize_lm_params(tp)
    for name in ("wq", "wk", "wv", "wo"):
        for i in range(len(tq["blocks"])):
            w = jp["blocks"][0]["attn"][name]["w"][i]
            q, s = jq.symmetric_quantize.__wrapped__(w, 8, (0,))
            got = tq["blocks"][i]["attn"][name]
            np.testing.assert_array_equal(got.w_q.numpy(),
                                          np.asarray(q, np.int8))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(s[0]))
    assert isinstance(tq["blocks"][0]["mlp"]["down"], QuantizedLinear)
    assert tq["embed"]["table"].dtype == torch.bfloat16


# ------------------------------------------------------------------ KV cache
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("vector_pos", [False, True])
def test_kv_write_matches_reference(quantized, vector_pos):
    b, s, hkv, hd, max_seq = 3, 4, 2, 16, 24
    rng = np.random.RandomState(5)
    kj, kt = _bf16(rng.randn(b, s, hkv, hd))
    vj, vt = _bf16(rng.randn(b, s, hkv, hd))
    pos = np.array([0, 7, 19]) if vector_pos else 5
    cj = JA.update_kv_cache(
        JA.init_kv_cache(b, max_seq, hkv, hd, quantized), kj, vj,
        jnp.asarray(pos, jnp.int32))
    ct = A.update_kv_cache(
        A.init_kv_cache(b, max_seq, hkv, hd, quantized, "cpu"), kt, vt,
        torch.from_numpy(pos) if vector_pos else pos)
    for key, leaf in ct.items():
        want = np.asarray(cj[key])
        if want.dtype == np.uint16:           # bf16 stored as raw words
            got = leaf.view(torch.int16).numpy().view(np.uint16)
        else:
            got = leaf.numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


# ------------------------------------------------------------------ the slice
@pytest.mark.parametrize("kind", ["fp", "hqp"])
@pytest.mark.parametrize("quantized_kv", [False, True])
def test_decode_matches_reference(models, kind, quantized_kv):
    """Prompt prefill plus 16 greedy decode steps, fed the reference's
    tokens: logits within LOGIT_ATOL at every step, the same greedy token
    wherever the reference's top-2 gap exceeds 2 * LOGIT_ATOL."""
    cfg, tcfg, weights, _ = models
    jp, tp = weights[kind]
    ctx = dataclasses.replace(default_ctx(), quantized_kv=quantized_kv)
    jstep = jax.jit(lambda p, st, t: jlm.decode_step(p, cfg, st, t, ctx))
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 11))
    jst = jlm.init_decode_state(cfg, 2, 48, ctx, params=jp)
    tst = lm.init_decode_state(tcfg, 2, 48, params=tp,
                               quantized_kv=quantized_kv, device="cpu")
    jtok, ttok = jnp.asarray(prompt, jnp.int32), torch.from_numpy(prompt)
    for step in range(N_STEPS + 1):
        jl, jst = jstep(jp, jst, jtok)
        tl, tst = lm.decode_step(tp, tcfg, tst, ttok,
                                 route="prefill" if step == 0 else "decode")
        a, b = np.asarray(jl[:, -1]), tl[:, 0].numpy()
        real = slice(0, cfg.vocab_size)
        np.testing.assert_allclose(b[:, real], a[:, real], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        top2 = np.sort(a[:, real], axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
        pick = b.argmax(-1)
        np.testing.assert_array_equal(pick[decided], a.argmax(-1)[decided],
                                      err_msg=f"step {step}")
        assert (a[np.arange(len(pick)), pick]
                >= top2[:, 1] - 2 * LOGIT_ATOL).all(), f"step {step}"
        assert (b[:, cfg.vocab_size:] == -1e30).all()
        nxt = a.argmax(-1)[:, None]
        jtok, ttok = jnp.asarray(nxt, jnp.int32), torch.from_numpy(nxt)


def test_pruned_artifact_sizes_its_own_cache(models):
    cfg, tcfg, weights, _ = models
    _, tp = weights["hqp"]
    st = lm.init_decode_state(tcfg, 1, 16, params=tp, quantized_kv=True,
                              device="cpu")
    for blk, cache in zip(tp["blocks"], st["caches"]):
        n_kv = blk["attn"]["wk"].w_q.shape[1] // tcfg.resolved_head_dim
        assert cache["k_q"].shape == (1, 16, n_kv, tcfg.resolved_head_dim)


# ------------------------------------------------------------------ artifacts
def test_load_artifact_is_byte_equal(models):
    """Every array the port loads equals the saved one byte for byte (the
    JAX package's stacked layer axis split per layer)."""
    _, _, weights, art_dir = models
    jp, tp = weights["hqp"]

    def raw(x):
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    def traw(t):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())

    def check(jt, tt, layer=None):
        sel = (lambda a: a) if layer is None else (lambda a: a[layer])
        if isinstance(tt, QuantizedLinear):
            for f in ("w_q", "scale"):
                got, want = traw(getattr(tt, f)), raw(sel(getattr(jt, f)))
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        elif isinstance(tt, dict):
            assert set(tt) == set(jt)
            for k in tt:
                check(jt[k], tt[k], layer)
        else:
            got, want = traw(tt), raw(sel(jt))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)

    for key in ("embed", "final_norm"):
        check(jp[key], tp[key])
    for i, blk in enumerate(tp["blocks"]):
        check(jp["blocks"][0], blk, layer=i)


def test_load_artifact_refuses_torn_write(models, tmp_path):
    import shutil
    _, _, _, art_dir = models
    torn = tmp_path / "torn"
    shutil.copytree(art_dir, torn)
    (torn / COMMIT_MARKER).unlink()
    with pytest.raises(FileNotFoundError, match="not committed"):
        load_artifact(str(torn), device="cpu")
