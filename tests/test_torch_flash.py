"""The train route's causal flash attention in the port, on the CPU, held
against the JAX package on the same numpy inputs: the plain version of the
kernel (``ref.flash_attention_ref``, which ``ops.flash_attention`` runs for
a CPU tensor) against ``flash_attention_pallas`` in interpret mode and the
JAX ``flash_attention_ref``; the model-level chunked flash against
``repro.models.attention.flash_attention``; and the explicit backward that
the CUDA path runs (called here on CPU tensors) against ``jax.grad``.

Tolerances:
  * plain vs the JAX oracle, f32 inputs: the same materialized f32
    arithmetic with sums in another order, 1e-5;
  * plain vs the Pallas kernel (online softmax over 64-128-row blocks):
    the repo's own tolerance for that kernel, 2e-2;
  * the model-level flash vs its JAX twin, bf16: the same staging (q scaled
    and rounded to bf16, f32 scores, p rounded to bf16 for PV) with sums in
    another order, which can move an output by one bf16 ulp (|out| <~ 4):
    rtol 2^-7, atol 1.6e-2;
  * the backward vs ``jax.grad`` of the JAX flash, bf16 inputs and
    gradients: both round the gradients to bf16 (2^-9) and the JAX
    autodiff also carries bf16 p and q through the scan, so each gradient
    is held within 2 % of its largest magnitude.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-2, atol=2e-2)
MODEL = dict(rtol=2 ** -7, atol=1.6e-2)
GRAD_FRAC = 2e-2


def _pair(a, dtype):
    """One f32 numpy array -> the same values in both frameworks."""
    a = np.asarray(a, np.float32)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _qkv(seed, b, s, hq, hkv, hd, dtype):
    rng = np.random.RandomState(seed)
    return [_pair(rng.randn(b, s, h, hd), dtype) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("bh,s,hd,bq,bk", [
    (4, 128, 64, 64, 64),
    (2, 256, 32, 128, 64),
    (1, 64, 128, 64, 64),
])
def test_plain_flash_vs_oracle_and_pallas(bh, s, hd, bq, bk):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(bh, 1, s, bh, bh, hd, "f32")
    out = ops.flash_attention(qt, kt, vt)
    np.testing.assert_allclose(_f32(out), _f32(jref.flash_attention_ref(
        qj, kj, vj)), **F32)
    fold = lambda t: jnp.moveaxis(t[0], 1, 0)          # (1, S, H, hd) -> (H, S, hd)
    pallas = flash_attention_pallas(fold(qj), fold(kj), fold(vj), bq=bq,
                                    bk=bk, interpret=True)
    np.testing.assert_allclose(_f32(out)[0], _f32(jnp.moveaxis(pallas, 0, 1)),
                               **PALLAS)


@pytest.mark.parametrize("hd", [64, 96, 128])
def test_plain_flash_bf16_gqa_vs_oracle(hd):
    """The plain version at the card's GQA shapes, bf16, hd 64 (the repo's
    qwen3-0.6b), 96 (phi-3-vision's) and 128 (the published qwen3's):
    against the JAX oracle on
    the heads repeated, both in f32 from the same bf16 values, then rounded
    to bf16 (one bf16 ulp)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(hd, 2, 40, 8, 4, hd, "bf16")
    out, lse = ref.flash_attention_lse_ref(qt, kt, vt)
    kr, vr = (jnp.repeat(t, 2, axis=2) for t in (kj, vj))
    want = jref.flash_attention_ref(*(t.astype(jnp.float32)
                                      for t in (qj, kr, vr)))
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=2 ** -8,
                               atol=2 ** -8)
    assert lse.shape == (2, 8, 40) and np.isfinite(_f32(lse)).all()


@pytest.mark.parametrize("q_offset", [0, 7])
def test_plain_flash_gqa_and_lse(q_offset):
    """GQA without a copy (query head h reads kv head h // G) equals the
    oracle on repeated heads; the log-sum-exp is that of the masked, scaled
    scores, computed here in float64."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 2, 24, 8, 2, 16, "f32")
    q = qt[:, :17]
    out, lse = ref.flash_attention_lse_ref(q, kt, vt, q_offset=q_offset)
    kr, vr = (jnp.repeat(t, 4, axis=2) for t in (kj, vj))
    np.testing.assert_allclose(
        _f32(out), _f32(jref.flash_attention_ref(qj[:, :17], kr, vr,
                                                 q_offset=q_offset)), **F32)
    s = np.einsum("bqhd,bkhd->bhqk", _f32(q).astype(np.float64),
                  np.repeat(_f32(kt), 4, axis=2).astype(np.float64)) / 4.0
    mask = np.arange(24)[None, :] <= q_offset + np.arange(17)[:, None]
    s = np.where(mask, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(_f32(lse), want, **F32)


@pytest.mark.parametrize("skv,chunk_kv", [(97, 32), (13, 1024), (33, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_model_flash_vs_reference(skv, chunk_kv, causal):
    """The chunked online softmax of the train route's CPU path, GQA and a
    ragged Skv (zero-padded to a chunk multiple, the tail masked)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(skv, 2, skv, 8, 4, 32, "bf16")
    out = A.flash_attention(qt, kt, vt, causal=causal, chunk_kv=chunk_kv)
    want = JA.flash_attention(qj, kj, vj, causal=causal, chunk_kv=chunk_kv)
    assert out.dtype == torch.bfloat16 and out.shape == qt.shape
    np.testing.assert_allclose(_f32(out), _f32(want), **MODEL)


def test_model_flash_q_offset():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(21, 2, 24, 4, 4, 32, "bf16")
    for off in (0, 7, 19):
        out = A.flash_attention(qt[:, :5], kt, vt, chunk_kv=8, q_offset=off)
        want = JA.flash_attention(qj[:, :5], kj, vj, chunk_kv=8,
                                  q_offset=off)
        np.testing.assert_allclose(_f32(out), _f32(want), **MODEL)


@pytest.mark.parametrize("s,hq,hkv,block_q", [(32, 4, 2, 512), (67, 6, 2, 16),
                                              (40, 4, 4, 8)])
def test_backward_vs_jax_grad(s, hq, hkv, block_q):
    """The explicit backward of the CUDA path (recomputed P from the saved
    log-sum-exp, dV, D = rowsum(dO∘O), dS, dQ, dK summed over the G query
    heads of each kv head), blockwise over query rows, against jax.grad
    through the JAX train route's flash. Here o and lse come from the plain
    version, as the kernel would give them."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(s, 2, s, hq, hkv, 32, "bf16")
    doj, dot = _pair(np.random.RandomState(99).randn(2, s, hq, 32), "bf16")
    out, lse = ref.flash_attention_lse_ref(qt, kt, vt)
    got = kf.flash_attention_backward(qt, kt, vt, out, lse, dot,
                                      block_q=block_q)

    def loss(q, k, v):
        o = JA.flash_attention(q, k, v, chunk_kv=16)
        return jnp.sum(o.astype(jnp.float32) * doj.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        w = _f32(w)
        np.testing.assert_allclose(_f32(g), w, rtol=0,
                                   atol=GRAD_FRAC * np.abs(w).max(),
                                   err_msg=f"d{name}")


def test_autograd_flows_through_the_plain_version():
    """A CPU tensor takes the plain version, and autograd through it gives
    the explicit backward's gradients (to a bf16 ulp of the largest)."""
    (_, qt), (_, kt), (_, vt) = _qkv(5, 1, 20, 4, 2, 16, "bf16")
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    d_out = torch.from_numpy(np.random.RandomState(6).randn(1, 20, 4, 16)
                             .astype(np.float32)).to(torch.bfloat16)
    auto = torch.autograd.grad(ops.flash_attention(*leaves), leaves, d_out)
    out, lse = ref.flash_attention_lse_ref(qt, kt, vt)
    explicit = kf.flash_attention_backward(qt, kt, vt, out, lse, d_out)
    for a, e in zip(auto, explicit):
        np.testing.assert_allclose(_f32(a), _f32(e), rtol=0,
                                   atol=2 ** -7 * _f32(a).__abs__().max())


def test_flash_wrapper_refuses_other_devices():
    # a meta tensor takes the plain version, shapes only (the dry run)
    q = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16, device="meta")
    out = ops.flash_attention(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape
    # a device that is not the CPU, the card or meta has no kernel
    other = types.SimpleNamespace(device=torch.device("xpu"),
                                  shape=(1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.flash_attention(other, other, other)
