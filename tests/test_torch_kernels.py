"""The port's kernel ops on the CPU (their plain PyTorch versions), held
against the JAX package on the same numpy inputs: its xla oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode; and, with
the launch stubbed, what the wrappers would launch on the card (the W8A8
GEMM's form by x's type, paged prefill at any table length).

Tolerances:
  * quantize and the int8 GEMM (also in the form that quantizes x itself)
    equal the oracle exactly (codes, scales, and the bf16 output bits);
  * quantize vs its Pallas kernel: under ``jit`` XLA rewrites the division
    of amax by the constant 127 into a multiply by fl(1/127), so a jitted
    scale can sit one f32 ulp from the true quotient that the eager oracle
    and the port compute (the all-zero row: 7.874016e-11 vs 7.874015e-11);
    scales within one ulp, codes within one;
  * the int8 GEMM's Pallas kernel evaluates its epilogue as acc*(xs*ws), the
    oracle's order is (acc*xs)*ws: one bf16 ulp (rtol 2^-8);
  * attention vs the oracle: the same staging, sums in another order and
    another exp — one bf16 ulp of outputs of magnitude <~ 4 (atol 1.6e-2,
    rtol 2^-7);
  * attention vs the Pallas kernels (online softmax, p kept in f32): the
    repo's own tolerance for them, rtol 3e-2 and atol 3e-2.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import decode_attention as jdec  # noqa: E402
from repro.kernels import int8_matmul as jmm  # noqa: E402
from repro.kernels import prefill_attention as jpre  # noqa: E402
from repro.kernels import quantize as jquant  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import int8_matmul as km  # noqa: E402
from repro_torch.kernels import kv_layout as kv  # noqa: E402
from repro_torch.kernels import prefill_attention as kp  # noqa: E402
from repro_torch.kernels import quantize as kq  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul  # noqa: E402
from repro_torch.kernels.quantize import quantize_rowwise  # noqa: E402

ATTN_REF = dict(rtol=2 ** -7, atol=1.6e-2)
ATTN_PALLAS = dict(rtol=3e-2, atol=3e-2)


def _bf16(a):
    """One f32 numpy array -> the same bf16 values in both frameworks."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------ quantize
@pytest.mark.parametrize("m,k", [(8, 64), (33, 100), (1, 256), (4, 1024)])
def test_quantize_equals_oracle_and_pallas(m, k):
    x = np.random.RandomState(m * 7 + k).randn(m, k) * 3
    x[m // 2] = 0.0                                   # an all-zero row
    xj, xt = _bf16(x)
    q, s = quantize_rowwise(xt)
    qj, sj = jref.quantize_ref(xj, axis=-1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert not q[m // 2].any()
    qp, sp = jquant.quantize_rowwise_pallas(xj, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=2 ** -23,
                               atol=0)
    assert np.abs(q.numpy().astype(int) - np.asarray(qp, int)).max() <= 1


# ------------------------------------------------------------------ int8 GEMM
@pytest.mark.parametrize("m,k,n", [(1, 96, 48), (4, 64, 128), (13, 130, 65),
                                   (37, 100, 257), (16, 3035, 1024),
                                   (16, 1024, 3035), (64, 3035, 1024),
                                   (64, 1024, 3035)])
def test_int8_matmul_equals_oracle(m, k, n):
    """The last four are the ragged shapes of a per-layer cut (d_ff 3,035)
    at a prefill chunk's M and past one 16-row tile, as the card checks
    them. Pallas in interpret mode runs one grid step per 32^3 block, so
    those take the oracle alone."""
    rng = np.random.RandomState(m + k + n)
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.rand(m) * 0.05 + 1e-3).astype(np.float32)
    ws = (rng.rand(n) * 0.05 + 1e-3).astype(np.float32)
    out = int8_matmul(*(torch.from_numpy(a) for a in (xq, wq, xs, ws)))
    want = jref.int8_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                                jnp.asarray(ws), jnp.asarray(xs))
    np.testing.assert_array_equal(_f32(out), _f32(want))
    if m * k * n > 2 ** 22:
        return
    pallas = jmm.int8_matmul_pallas(jnp.asarray(xq), jnp.asarray(wq),
                                    jnp.asarray(xs), jnp.asarray(ws), bm=32,
                                    bn=32, bk=32, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(pallas), rtol=2 ** -8, atol=0)


def test_int8_matmul_epilogue_order_at_scale():
    """(acc*xs)*ws and acc*(xs*ws) round to the same bf16 almost always;
    262k outputs are enough for this seed to tell them apart."""
    rng = np.random.RandomState(0)
    xq = rng.randint(-127, 128, (256, 96)).astype(np.int8)
    wq = rng.randint(-127, 128, (96, 1024)).astype(np.int8)
    xs = (rng.rand(256) * 0.05 + 1e-3).astype(np.float32)
    ws = (rng.rand(1024) * 0.05 + 1e-3).astype(np.float32)
    out = int8_matmul(*(torch.from_numpy(a) for a in (xq, wq, xs, ws)))
    want = jref.int8_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                                jnp.asarray(ws), jnp.asarray(xs))
    np.testing.assert_array_equal(_f32(out), _f32(want))


def test_ops_int8_matmul_quantizes_activations():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 40)
    w = rng.randn(40, 24).astype(np.float32)
    wq, wsc = jref.quantize_ref(jnp.asarray(w), axis=0)
    xj, xt = _bf16(x)
    out = ops.int8_matmul(xt, torch.tensor(np.asarray(wq)),
                          torch.tensor(np.asarray(wsc)))
    want = jops.int8_matmul(xj, wq, wsc)
    assert out.shape == (2, 3, 24)
    np.testing.assert_array_equal(_f32(out), _f32(want))


@pytest.mark.parametrize("m,k,n", [(1, 96, 48), (4, 64, 128), (13, 130, 65),
                                   (16, 3035, 64), (17, 256, 40)])
def test_int8_matmul_quant_equals_ops_and_pallas(m, k, n):
    """The fused form (B2's quantization as B1's prologue), plain version:
    its output equals the JAX package's ``ops.int8_matmul`` on a float x
    exactly, and the codes and scales it hands back equal the oracle's
    exactly and ``quantize_rowwise_pallas``'s within C1's one ulp (scales)
    and one code. K 130 and 3,035 are ragged (no 16-byte rows on the
    card)."""
    rng = np.random.RandomState(m * 31 + k + n)
    x = rng.randn(m, k) * 3
    x[m // 2] = 0.0                                   # an all-zero row
    wq, wsc = jref.quantize_ref(jnp.asarray(rng.randn(k, n), jnp.float32),
                                axis=0)
    xj, xt = _bf16(x)
    out_q = torch.empty(m, k, dtype=torch.int8)
    out_s = torch.empty(m, dtype=torch.float32)
    out = km.int8_matmul_quant(xt, torch.tensor(np.asarray(wq)),
                               torch.tensor(np.asarray(wsc)), out_q, out_s)
    np.testing.assert_array_equal(_f32(out),
                                  _f32(jops.int8_matmul(xj, wq, wsc)))
    qj, sj = jref.quantize_ref(xj, axis=-1)
    np.testing.assert_array_equal(out_q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(sj))
    qp, sp = jquant.quantize_rowwise_pallas(xj, interpret=True)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(sp), rtol=2 ** -23,
                               atol=0)
    assert np.abs(out_q.numpy().astype(int) - np.asarray(qp, int)).max() <= 1


def _stub_launches(monkeypatch):
    """Tensors on the CPU take the kernel path up to the launch, which is
    recorded (kernel name, arguments) instead of made."""
    calls = []
    monkeypatch.setattr(build, "runs_plain", lambda t: False)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    for kern in (km.KERNEL, km.QUANT_KERNEL, kq.KERNEL, kp.KERNEL,
                 kp.PAGED_KERNEL):
        monkeypatch.setattr(kern, "launch", lambda *a, k=kern, stream: (
            calls.append((k.symbol, a))))
    monkeypatch.setattr(km, "WORKSPACES", build.Workspaces(
        km.WORKSPACES.what, km.WORKSPACES.minimum))
    return calls


def test_ops_int8_matmul_sends_float_x_to_the_fused_kernel(monkeypatch):
    """On a CUDA tensor ``ops.int8_matmul`` launches the fused form for a
    float x, with the bf16-x plan (16-byte loads, the scales' shared
    memory), and B1 alone for an int8 x with static scales; never B2."""
    calls = _stub_launches(monkeypatch)
    m, k, n = 4, 1024, 3072
    wq = torch.zeros(k, n, dtype=torch.int8)
    ws = torch.ones(n, dtype=torch.float32)
    x = torch.zeros(2, m // 2, k, dtype=torch.bfloat16)
    assert ops.int8_matmul(x, wq, ws).shape == (2, m // 2, n)
    (name, args), = calls
    plan = km.gemm_plan(m, n, k, wq.data_ptr(), x.data_ptr(), x_bytes=2)
    assert name == "int8_matmul_quant" and plan.x_vec == 16
    assert args[6:8] == (0, 0)                 # no check outputs
    assert args[8:] == (m, n, k, plan.ksteps, plan.split, plan.vec,
                        plan.x_vec, plan.smem)
    calls.clear()
    xq = torch.zeros(m, k, dtype=torch.int8)
    out = ops.int8_matmul(xq, wq, ws, x_scale=torch.ones(m))
    assert out.shape == (m, n)
    (name, args), = calls
    plan = km.gemm_plan(m, n, k, wq.data_ptr(), xq.data_ptr())
    assert name == "int8_matmul" and plan.x_vec == 4
    assert args[7:] == (m, n, k, plan.ksteps, plan.split, plan.vec,
                        plan.x_vec, plan.smem)


# ------------------------------------------------------------------ attention
B, HQ, HKV, HD = 3, 8, 4, 32


def _cache(seed, w, quantized, hkv=HKV, hd=HD):
    rng = np.random.RandomState(seed)
    if quantized:
        kq = rng.randint(-127, 128, (B, w, hkv, hd)).astype(np.int8)
        vq = rng.randint(-127, 128, (B, w, hkv, hd)).astype(np.int8)
        ks = (rng.rand(B, w, hkv) * 0.02 + 0.005).astype(np.float32)
        vs = (rng.rand(B, w, hkv) * 0.02 + 0.005).astype(np.float32)
        arrays = {"k_q": kq, "v_q": vq, "k_s": ks, "v_s": vs}
        return ({k: jnp.asarray(a) for k, a in arrays.items()},
                {k: torch.from_numpy(a) for k, a in arrays.items()})
    kj, kt = _bf16(rng.randn(B, w, hkv, hd))
    vj, vt = _bf16(rng.randn(B, w, hkv, hd))
    return {"k": kj, "v": vj}, {"k": kt, "v": vt}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("sq,starts,window", [
    (5, (0, 11, 3), 32),          # ragged chunk, per-slot starts
    (16, (16, 0, 40), None),      # a full chunk, whole buffer
    (1, (63, 7, 0), 64),          # a 1-token tail chunk at W-1
])
def test_prefill_attention_vs_oracle_and_pallas(quantized, sq, starts,
                                                window):
    w = 64
    cj, ct = _cache(sq + w, w, quantized)
    qj, qt = _bf16(np.random.RandomState(sq).randn(B, sq, HQ, HD))
    start = np.asarray(starts, np.int32)
    out = ops.prefill_attention(qt, ct, torch.from_numpy(start), window)
    want = jops.cached_attention(qj, cj, jnp.asarray(start), window)
    np.testing.assert_allclose(_f32(out), _f32(want), **ATTN_REF)
    kj, vj, ksj, vsj = jops._cache_window(cj, window)
    pallas = jpre.prefill_attention_pallas(qj, kj, vj, ksj, vsj,
                                           jnp.asarray(start), bq=8, bk=16,
                                           interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **ATTN_PALLAS)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("hq,hkv,hd", [(4, 4, 64), (6, 2, 16), (8, 2, 128),
                                       (4, 4, 96)])
def test_prefill_attention_heads_and_widths_vs_oracle(quantized, hq, hkv,
                                                      hd):
    """The plain prefill at the other head groupings (G = 1, 3, 4) and
    widths (hd 16, 64, 96, 128) that the card holds its kernel to."""
    sq = 7
    cj, ct = _cache(hq * 100 + hd, 48, quantized, hkv, hd)
    qj, qt = _bf16(np.random.RandomState(hd).randn(B, sq, hq, hd))
    start = np.asarray([40, 3, 17], np.int32)
    out = ops.prefill_attention(qt, ct, torch.from_numpy(start))
    want = jops.cached_attention(qj, cj, jnp.asarray(start), None)
    assert out.shape == (B, sq, hq, hd)
    np.testing.assert_allclose(_f32(out), _f32(want), **ATTN_REF)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("starts,window", [((0, 31, 12), 32),
                                           ((50, 3, 63), None)])
def test_decode_attention_vs_oracle_and_pallas(quantized, starts, window):
    w = 64
    cj, ct = _cache(len(starts) + w, w, quantized)
    qj, qt = _bf16(np.random.RandomState(1).randn(B, 1, HQ, HD))
    start = np.asarray(starts, np.int32)
    out = ops.decode_attention(qt, ct, torch.from_numpy(start), window)
    want = jops.cached_attention(qj, cj, jnp.asarray(start), window)
    assert out.shape == (B, 1, HQ, HD)
    np.testing.assert_allclose(_f32(out), _f32(want), **ATTN_REF)
    kj, vj, ksj, vsj = jops._cache_window(cj, window)
    pallas = jdec.decode_attention_pallas(qj[:, 0], kj, vj, ksj, vsj,
                                          jnp.asarray(start), bk=16,
                                          interpret=True)
    np.testing.assert_allclose(_f32(out[:, 0]), _f32(pallas), **ATTN_PALLAS)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("hq,hkv,hd,w,starts,bk", [
    (16, 8, 64, 64, (63, 17, 0), 32),         # the serve grouping: G 2, hd 64
    (4, 2, 32, 320, (255, 256, 257), 64),     # around a 256-position boundary
    (2, 2, 96, 320, (255, 256, 257), 64),     # phi-3-vision's G 1, hd 96
])
def test_decode_attention_serve_grouping_and_segment_boundary(
        quantized, hq, hkv, hd, w, starts, bk):
    """The decode function that the card's split-KV kernel must keep: at the
    serve grouping, and for slots just before, at and past the first
    boundary of its 256-position segments; against the oracle and against
    ``decode_attention_pallas`` in interpret mode."""
    cj, ct = _cache(hd + w, w, quantized, hkv, hd)
    qj, qt = _bf16(np.random.RandomState(w).randn(B, 1, hq, hd))
    start = np.asarray(starts, np.int32)
    out = ops.decode_attention(qt, ct, torch.from_numpy(start))
    want = jops.cached_attention(qj, cj, jnp.asarray(start), None)
    assert out.shape == (B, 1, hq, hd)
    np.testing.assert_allclose(_f32(out), _f32(want), **ATTN_REF)
    kj, vj, ksj, vsj = jops._cache_window(cj, None)
    pallas = jdec.decode_attention_pallas(qj[:, 0], kj, vj, ksj, vsj,
                                          jnp.asarray(start), bk=bk,
                                          interpret=True)
    np.testing.assert_allclose(_f32(out[:, 0]), _f32(pallas), **ATTN_PALLAS)


@pytest.mark.parametrize("quantized", [False, True])
def test_windowed_attend_equals_full_buffer(quantized):
    """Positions past the window mask to exact zeros: a window that covers
    every consumed row gives the full buffer's bits."""
    _, ct = _cache(9, 64, quantized)
    _, qt = _bf16(np.random.RandomState(2).randn(B, 4, HQ, HD))
    start = torch.tensor([0, 5, 12], dtype=torch.int32)
    full = ops.prefill_attention(qt, ct, start, None)
    assert torch.equal(ops.prefill_attention(qt, ct, start, 16), full)


@pytest.mark.parametrize("quantized", [False, True])
def test_rows_past_the_window_see_the_whole_window(quantized):
    """A slot at or past the window's end attends every position of the
    window, as the reference does: the same bits as a slot at W - 1. The
    CUDA kernels clamp each row's limit to W - 1 to keep this."""
    w = 16
    cj, ct = _cache(11, w, quantized)
    qj, qt = _bf16(np.random.RandomState(3).randn(B, 1, HQ, HD))
    start = np.asarray([w - 1, w + 2, 3 * w], np.int32)
    out = ops.decode_attention(qt, ct, torch.from_numpy(start), None)
    at_end = ops.decode_attention(
        qt, ct, torch.full((B,), w - 1, dtype=torch.int32), None)
    assert torch.equal(out, at_end)
    want = jops.cached_attention(qj, cj, jnp.asarray(start), None)
    np.testing.assert_allclose(_f32(out), _f32(want), **ATTN_REF)


LONG_PAGES, LONG_PAGE = 2560, 16     # qwen3-0.6b's 40,960 positions


def _long_paged_case(quantized, sq=4):
    """One slot whose table maps LONG_PAGES pages of LONG_PAGE in a random
    physical order (past the 2,048 entries B6 once held in shared memory),
    at a small width (Hq 2, Hkv 1, hd 16); its queries' window passes
    32,768 positions."""
    rng = np.random.RandomState(5 + quantized)
    n_pages = LONG_PAGES + 1
    shape = (n_pages, LONG_PAGE, 1, 16)
    if quantized:
        arena = [rng.randint(-127, 128, shape).astype(np.int8) for _ in "kv"]
        arena += [(rng.rand(*shape[:3]) * 0.02 + 0.005).astype(np.float32)
                  for _ in "kv"]
    else:
        arena = [rng.randn(*shape).astype(np.float32) for _ in "kv"]
    tab = (rng.permutation(LONG_PAGES) + 1).astype(np.int32)[None]
    start = np.asarray([LONG_PAGES * LONG_PAGE - sq - 3], np.int32)
    q = rng.randn(1, sq, 2, 16).astype(np.float32)
    return arena, tab, start, q


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_prefill_takes_a_table_past_2048_pages(quantized):
    """B6 at 2,560 pages of 16: the plain version equals the contiguous
    op on the gathered window bit for bit, and the JAX oracle within
    ATTN_REF."""
    arena, tab, start, q = _long_paged_case(quantized)
    if quantized:
        leaves_t = [torch.from_numpy(a) for a in arena]
        leaves_j = [jnp.asarray(a) for a in arena]
    else:
        pairs = [_bf16(a) for a in arena]
        leaves_j = [j for j, _ in pairs] + [None, None]
        leaves_t = [t for _, t in pairs] + [None, None]
    qj, qt = _bf16(q)
    st, tt = torch.from_numpy(start), torch.from_numpy(tab)
    out = kp.paged_prefill_attention(qt, *leaves_t, st, tt)
    gathered = [None if t is None else kv.gather_pages(t, tt)
                for t in leaves_t]
    assert gathered[0].shape[1] == LONG_PAGES * LONG_PAGE
    assert torch.equal(out, kp.prefill_attention(qt, *gathered, st))
    want = jref.paged_prefill_attention_ref(qj, *leaves_j, jnp.asarray(start),
                                            jnp.asarray(tab))
    np.testing.assert_allclose(_f32(out), _f32(want), **ATTN_REF)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_prefill_wrapper_launches_any_table_length(quantized,
                                                         monkeypatch):
    """On a CUDA tensor the B6 wrapper no longer refuses a table of more
    than 2,048 entries: it launches with the whole table's length."""
    arena, tab, start, q = _long_paged_case(quantized)
    leaves = [torch.from_numpy(a) for a in arena]
    if not quantized:
        leaves = [t.to(torch.bfloat16) for t in leaves] + [None, None]
    calls = _stub_launches(monkeypatch)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    out = kp.paged_prefill_attention(qt, *leaves, torch.from_numpy(start),
                                     torch.from_numpy(tab))
    assert out.shape == qt.shape
    (name, args), = calls
    # (..., B, Sq, n_blk, page_size, Hkv, G, hd, quantized, ...)
    assert name == "paged_prefill_attention"
    assert args[8:16] == (1, 4, LONG_PAGES, LONG_PAGE, 1, 2, 16,
                          int(quantized))


def test_kernel_wrappers_refuse_other_devices():
    # a meta tensor takes the plain version, shapes only (the dry run)
    x = torch.zeros(2, 4, dtype=torch.bfloat16, device="meta")
    q, s = quantize_rowwise(x)
    assert q.device.type == s.device.type == "meta"
    assert q.shape == (2, 4) and q.dtype == torch.int8 and s.shape == (2,)
    # a device that is not the CPU, the card or meta has no kernel
    other = types.SimpleNamespace(device=torch.device("xpu"), shape=(2, 4))
    with pytest.raises(RuntimeError, match="no kernel"):
        quantize_rowwise(other)
