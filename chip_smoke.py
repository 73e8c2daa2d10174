#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card: build the CUDA
kernels, hold each against its plain PyTorch version at the shapes of the
serving path (the paged ones also bit for bit against their contiguous
twins on the gathered window), then serve the full-width qwen3-0.6b (random
weights from a seed, INT8 PTQ) through the continuous-batching engine, with
a contiguous KV pool and with a paged KV arena and its prefix cache, and
check every request against serial decode; last, profile a steady decode
dispatch (where its time goes on the card).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits nonzero on any failure, and when
there is no card or no ``src/repro_torch`` beside this file. The last line
of standard output is ``{"ok": true, "device": {...}}``; the line before it
is the ``kernels`` JSON (times, bounds, launches on the serving run).
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_CHUNK, SERVE_STEPS = 4, 256, 16, 4
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 6, 48, 32
SERVE_PAGE = 16             # page size of the paged serve phase
SHARED_HEAD, SHARED_N = 64, 6   # shared-prompt load: head tokens, requests
PAGE_SIZES = (16, 32, 48, 256)  # paged kernel checks
PROFILE_TICKS = 10          # decode dispatches timed in the profile phase

# Attention tolerance, |kernel - plain| <= ATOL + RTOL * |plain|: the plain
# version rounds p to bf16 before PV (relative error <= 2^-9 per term), the
# kernel keeps p in f32; both round the output to bf16 (2^-9 relative); the
# f32 sums run in another order. With unit-normal q, k, v (|v| <~ 5) that
# stays under 2e-2.
ATTN_ATOL, ATTN_RTOL = 3e-2, 3e-2
# Card vs CPU plain path on the smoke model, f32 logits of magnitude <~ 1:
# attention differs as above, which can move an int8 activation code by one.
E2E_ATOL = 5e-2


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def phase_quantize(dev, report):
    import torch
    from repro_torch.kernels import quantize as kq, ref
    err = 0.0
    for m in (4, 7, 16):
        for k in (1024, 3072):
            x = torch.randn(m, k, device=dev).to(torch.bfloat16) * 3
            x[m // 2] = 0                               # an all-zero row
            q, s = kq.quantize_rowwise(x)
            qr, sr = ref.quantize_ref(x)
            torch.cuda.synchronize()
            if not (torch.equal(q, qr) and torch.equal(s, sr)):
                fail(f"quantize_rowwise ({m}, {k}) differs from plain")
            err = max(err, (q.float() - qr.float()).abs().max().item(),
                      (s - sr).abs().max().item())
    m, k = SERVE_SLOTS, 1024
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    ms = time_ms(lambda: kq.quantize_rowwise(x))
    plain = time_ms(lambda: ref.quantize_ref(x))
    b, by = bound(m * k * 3 + m * 4, 0, "bf16")
    report["quantize_rowwise"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape=f"x ({m}, {k}) bf16")


def phase_int8_matmul(dev, report):
    import torch
    from repro_torch.kernels import int8_matmul as km, ref
    gen = lambda *shape: torch.randint(-127, 128, shape, device=dev,
                                       dtype=torch.int8)
    err = 0.0
    for m in (1, 4, 13, 16):
        for k, n in ((1024, 1024), (1024, 512), (1024, 3072), (3072, 1024)):
            xq, wq = gen(m, k), gen(k, n)
            xs = torch.rand(m, device=dev) * 0.05 + 1e-3
            ws = torch.rand(n, device=dev) * 0.05 + 1e-3
            out = km.int8_matmul(xq, wq, xs, ws)
            want = ref.int8_matmul_ref(xq, wq, xs, ws)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                fail(f"int8_matmul M={m} K={k} N={n} differs from plain")
            err = max(err, (out.float() - want.float()).abs().max().item())
    # decode's gate/up shape; weights rotate through > 50 MB so that, as in
    # a decode step, each call reads its weight from device memory
    m, k, n = SERVE_SLOTS, 1024, 3072
    xq = gen(m, k)
    xs = torch.rand(m, device=dev) * 0.05
    ws = torch.rand(n, device=dev) * 0.05
    weights = [gen(k, n) for _ in range(24)]
    it = iter(range(10 ** 9))
    ms = time_ms(lambda: km.int8_matmul(xq, weights[next(it) % 24], xs, ws))
    plain = time_ms(lambda: ref.int8_matmul_ref(xq, weights[next(it) % 24],
                                                xs, ws))
    b, by = bound(m * k + k * n + (m + n) * 4 + m * n * 2, 2 * m * n * k,
                  "int8")
    # torch._int_mm needs M > 16: no library call at decode's M
    report["int8_matmul"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape=f"({m}, {k}) x ({k}, {n}) int8")


def _kv(dev, b, w, hkv, hd, quantized):
    import torch
    from repro_torch.models.attention import _quant_kv
    k = torch.randn(b, w, hkv, hd, device=dev).to(torch.bfloat16)
    v = torch.randn(b, w, hkv, hd, device=dev).to(torch.bfloat16)
    if not quantized:
        return k, v, None, None
    (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
    return kq, vq, ks, vs


def _attn_err(out, want, what):
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite output")
    d = (out.float() - want.float()).abs()
    if not (d <= ATTN_ATOL + ATTN_RTOL * want.float().abs()).all():
        fail(f"{what}: max |kernel - plain| = {d.max().item():.4g} over the "
             f"stated tolerance")
    return d.max().item()


def _sdpa_ms(q, k, v, start, sq):
    """scaled_dot_product_attention on GQA heads expanded to Hq, with the
    per-row causal mask: the library yardstick for bf16 attention."""
    import torch
    import torch.nn.functional as F
    b, w, hkv, hd = k.shape
    g = q.shape[2] // hkv
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    lim = start[:, None] + torch.arange(sq, device=q.device)[None]
    mask = (torch.arange(w, device=q.device)[None, None]
            <= lim[..., None])[:, None]
    return time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask))


def phase_decode(dev, report):
    import torch
    from repro_torch.kernels import decode_attention as kd, ref
    b, hq, hkv, hd = SERVE_SLOTS, 16, 8, 64
    err = 0.0
    for quantized in (False, True):
        for w in (16, 64, 256):
            k, v, ks, vs = _kv(dev, b, 256, hkv, hd, quantized)
            start = torch.tensor([0, w - 1, w // 3, (2 * w) // 3],
                                 dtype=torch.int32, device=dev)
            q = torch.randn(b, hq, hd, device=dev).to(torch.bfloat16)
            win = lambda t: None if t is None else t[:, :w]
            out = kd.decode_attention(q, win(k), win(v), win(ks), win(vs),
                                      start)
            want = ref.decode_attention_ref(q, win(k), win(v), win(ks),
                                            win(vs), start)
            err = max(err, _attn_err(out, want,
                                     f"decode W={w} int8={quantized}"))
            full = kd.decode_attention(q, k, v, ks, vs, start)
            torch.cuda.synchronize()
            if not torch.equal(out, full):
                fail(f"decode W={w} int8={quantized}: windowed != full")
        # slots at or past the window's end see the whole window
        w = 16
        k, v, ks, vs = _kv(dev, b, w, hkv, hd, quantized)
        start = torch.tensor([w - 1, w, w + 7, 3 * w], dtype=torch.int32,
                             device=dev)
        q = torch.randn(b, hq, hd, device=dev).to(torch.bfloat16)
        err = max(err, _attn_err(
            kd.decode_attention(q, k, v, ks, vs, start),
            ref.decode_attention_ref(q, k, v, ks, vs, start),
            f"decode W={w} starts past the window int8={quantized}"))
    # serve's decode at a 64-token window, every slot at position 63: INT8 KV
    # (the main path's) in the kernels line, bf16 KV beside it
    w = 64
    k, v, _, _ = _kv(dev, b, w, hkv, hd, False)
    kq, vq, ks, vs = _kv(dev, b, w, hkv, hd, True)
    q = torch.randn(b, hq, hd, device=dev).to(torch.bfloat16)
    start = torch.full((b,), w - 1, dtype=torch.int32, device=dev)
    n_kv, n_ops = b * w * hkv * hd, 4 * b * hq * hd * w
    io = b * hq * hd * 2 * 2 + b * 4                   # q, out, start
    b_ms, by = bound(n_kv * 2 + b * w * hkv * 4 * 2 + io, n_ops, "int8")
    b16_ms, b16_by = bound(n_kv * 2 * 2 + io, n_ops, "bf16")
    report["decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kd.decode_attention(q, kq, vq, ks, vs, start)),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, kq, vq, ks, vs,
                                                          start)),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        bf16_kv=dict(
            ms=time_ms(lambda: kd.decode_attention(q, k, v, None, None,
                                                   start)),
            plain_ms=time_ms(lambda: ref.decode_attention_ref(
                q, k, v, None, None, start)),
            bound_ms=b16_ms, bound_by=b16_by,
            library_ms=_sdpa_ms(q[:, None], k, v, start, 1)),
        shape=f"q ({b}, {hq}, {hd}) vs INT8 KV ({b}, {w}, {hkv}, {hd})")


def phase_prefill(dev, report):
    import torch
    from repro_torch.kernels import prefill_attention as kp, ref
    hq, hkv, hd = 16, 8, 64
    err = 0.0
    for quantized in (False, True):
        for sq in (16, 5, 1):
            for st in (0, 16, 37):
                w = -(-(st + sq) // 16) * 16
                k, v, ks, vs = _kv(dev, 2, w, hkv, hd, quantized)
                q = torch.randn(2, sq, hq, hd, device=dev).to(torch.bfloat16)
                start = torch.tensor([st, 0], dtype=torch.int32, device=dev)
                out = kp.prefill_attention(q, k, v, ks, vs, start)
                want = ref.cached_attention_ref(q, k, v, ks, vs, start)
                err = max(err, _attn_err(
                    out, want, f"prefill Sq={sq} start={st} int8={quantized}"))
        # queries at or past the window's end see the whole window
        for st, sq, w in ((15, 5, 16), (40, 3, 32)):
            k, v, ks, vs = _kv(dev, 2, w, hkv, hd, quantized)
            q = torch.randn(2, sq, hq, hd, device=dev).to(torch.bfloat16)
            start = torch.tensor([st, w - 2], dtype=torch.int32, device=dev)
            err = max(err, _attn_err(
                kp.prefill_attention(q, k, v, ks, vs, start),
                ref.cached_attention_ref(q, k, v, ks, vs, start),
                f"prefill W={w} start={st} past the window int8={quantized}"))
        # chunk == whole on the kernel itself: a 53-token prompt in chunks of
        # 16, each against its own 16-bucketed window
        n, w = 53, 64
        k, v, ks, vs = _kv(dev, 1, w, hkv, hd, quantized)
        q = torch.randn(1, n, hq, hd, device=dev).to(torch.bfloat16)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        whole = kp.prefill_attention(q, k, v, ks, vs, zero)
        win = lambda t, c: None if t is None else t[:, :c]
        for lo in range(0, n, 16):
            hi = min(n, lo + 16)
            c = -(-hi // 16) * 16
            part = kp.prefill_attention(
                q[:, lo:hi].contiguous(), win(k, c), win(v, c), win(ks, c),
                win(vs, c), torch.full((1,), lo, dtype=torch.int32,
                                       device=dev))
            torch.cuda.synchronize()
            if not torch.equal(part, whole[:, lo:hi]):
                fail(f"prefill chunk [{lo}, {hi}) int8={quantized} is not "
                     f"bitwise equal to whole-prompt prefill")
    # serve's prefill chunk: 16 queries at 37.. against a 64-token window,
    # INT8 KV (the main path's) in the kernels line, bf16 KV beside it
    sq, st, w = 16, 37, 64
    k, v, _, _ = _kv(dev, 1, w, hkv, hd, False)
    kq, vq, ks, vs = _kv(dev, 1, w, hkv, hd, True)
    q = torch.randn(1, sq, hq, hd, device=dev).to(torch.bfloat16)
    start = torch.full((1,), st, dtype=torch.int32, device=dev)
    visible = sum(st + i + 1 for i in range(sq))    # causal (query, kv) pairs
    n_ops = 4 * hq * hd * visible
    seen = (st + sq) * hkv                          # the prefix the chunk sees
    io = sq * hq * hd * 2 * 2 + 4                   # q, out, start
    b_ms, by = bound(seen * hd * 2 + seen * 4 * 2 + io, n_ops, "int8")
    b16_ms, b16_by = bound(seen * hd * 2 * 2 + io, n_ops, "bf16")
    report["prefill_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kp.prefill_attention(q, kq, vq, ks, vs, start)),
        plain_ms=time_ms(lambda: ref.cached_attention_ref(q, kq, vq, ks, vs,
                                                          start)),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        bf16_kv=dict(
            ms=time_ms(lambda: kp.prefill_attention(q, k, v, None, None,
                                                    start)),
            plain_ms=time_ms(lambda: ref.cached_attention_ref(
                q, k, v, None, None, start)),
            bound_ms=b16_ms, bound_by=b16_by,
            library_ms=_sdpa_ms(q, k, v, start, sq)),
        shape=f"q (1, {sq}, {hq}, {hd}) at {st} vs INT8 KV (1, {w}, {hkv}, "
              f"{hd})")


# ------------------------------------------------------------ paged kernels
def _paged_case(dev, ps, quantized, limits, hkv=8, hd=64, max_seq=256):
    """A paged arena whose pages sit in a random physical order, and a
    (B, max_pages) table: row r maps the pages covering positions
    0..limits[r]; its other entries point at the trash page 0, which holds
    random values like every other page."""
    import torch
    from repro_torch.kernels.kv_layout import page_count
    max_pages = page_count(max_seq, ps)
    n_pages = 1 + len(limits) * max_pages
    k, v, ks, vs = _kv(dev, n_pages, ps, hkv, hd, quantized)
    perm = (torch.randperm(n_pages - 1) + 1).tolist()
    table = torch.zeros(len(limits), max_pages, dtype=torch.int32)
    for r, lim in enumerate(limits):
        n = min(page_count(lim + 1, ps), max_pages)
        table[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return (k, v, ks, vs), table.to(dev)


def _gathered(arena, idx):
    from repro_torch.kernels.kv_layout import gather_pages
    return [None if t is None else gather_pages(t, idx) for t in arena]


def _equal(a, b, what):
    import torch
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        d = (a.float() - b.float()).abs().max().item()
        fail(f"{what}: not bitwise equal (max |diff| {d:.4g})")


def phase_paged_decode(dev, report):
    import torch
    from repro_torch.kernels import decode_attention as kd, ref
    from repro_torch.kernels.kv_layout import window_pages
    b, hq, hkv, hd = SERVE_SLOTS, 16, 8, 64
    err = 0.0
    for quantized in (False, True):
        for ps in PAGE_SIZES:
            for window in (64, 256):
                starts = [0, window - 1, window // 3, window + 5]
                arena, table = _paged_case(dev, ps, quantized, starts)
                idx = window_pages(table, ps, window).contiguous()
                start = torch.tensor(starts, dtype=torch.int32, device=dev)
                q = torch.randn(b, hq, hd, device=dev).to(torch.bfloat16)
                what = f"paged decode page={ps} W={window} int8={quantized}"
                out = kd.paged_decode_attention(q, *arena, start, idx)
                err = max(err, _attn_err(
                    out, ref.paged_decode_attention_ref(q, *arena, start,
                                                        idx), what))
                _equal(out, kd.decode_attention(q, *_gathered(arena, idx),
                                                start), what + " vs B3")
    # serve's paged decode: 64-token window in pages of 16, every slot at
    # position 63, INT8 KV (the main path's), bf16 KV beside it
    w, ps = 64, SERVE_PAGE
    starts = [w - 1] * b
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    q = torch.randn(b, hq, hd, device=dev).to(torch.bfloat16)
    arena_q, table = _paged_case(dev, ps, True, starts)
    arena_b, _ = _paged_case(dev, ps, False, starts)
    idx = window_pages(table, ps, w).contiguous()
    n_kv, n_ops = b * w * hkv * hd, 4 * b * hq * hd * w
    io = b * hq * hd * 2 * 2 + b * 4 + idx.numel() * 4  # q, out, start, table
    b_ms, by = bound(n_kv * 2 + b * w * hkv * 4 * 2 + io, n_ops, "int8")
    b16_ms, b16_by = bound(n_kv * 2 * 2 + io, n_ops, "bf16")
    gk, gv, _, _ = _gathered(arena_b, idx)
    report["paged_decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kd.paged_decode_attention(q, *arena_q, start,
                                                     idx)),
        plain_ms=time_ms(lambda: ref.paged_decode_attention_ref(
            q, *arena_q, start, idx)),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        bf16_kv=dict(
            ms=time_ms(lambda: kd.paged_decode_attention(q, *arena_b, start,
                                                         idx)),
            plain_ms=time_ms(lambda: ref.paged_decode_attention_ref(
                q, *arena_b, start, idx)),
            bound_ms=b16_ms, bound_by=b16_by,
            library_ms=_sdpa_ms(q[:, None], gk, gv, start, 1),
            library="SDPA on the gathered window, gather not timed"),
        shape=f"q ({b}, {hq}, {hd}) vs INT8 arena, pages of {ps}, window "
              f"{w}")


def phase_paged_prefill(dev, report):
    import torch
    from repro_torch.kernels import prefill_attention as kp, ref
    from repro_torch.kernels.kv_layout import page_count, window_pages
    b, hq, hkv, hd = SERVE_SLOTS, 16, 8, 64
    err = 0.0
    for quantized in (False, True):
        for ps in PAGE_SIZES:
            for sq in (16, 5, 1):
                starts = [0, 16, 37, 200 - sq]
                window = -(-(max(starts) + sq) // 16) * 16
                arena, table = _paged_case(
                    dev, ps, quantized, [s + sq - 1 for s in starts])
                idx = window_pages(table, ps, window).contiguous()
                start = torch.tensor(starts, dtype=torch.int32, device=dev)
                q = torch.randn(b, sq, hq, hd, device=dev).to(torch.bfloat16)
                what = f"paged prefill page={ps} Sq={sq} int8={quantized}"
                out = kp.paged_prefill_attention(q, *arena, start, idx)
                err = max(err, _attn_err(
                    out, ref.paged_prefill_attention_ref(q, *arena, start,
                                                         idx), what))
                _equal(out, kp.prefill_attention(q, *_gathered(arena, idx),
                                                 start), what + " vs B4")
            # chunk == whole: a 53-token prompt in chunks of 16, each chunk
            # against the page-rounded window the engine would give it
            n = 53
            arena, table = _paged_case(dev, ps, quantized, [n - 1])
            q = torch.randn(1, n, hq, hd, device=dev).to(torch.bfloat16)
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            whole = kp.paged_prefill_attention(
                q, *arena, zero, window_pages(table, ps, 64).contiguous())
            for lo in range(0, n, 16):
                hi = min(n, lo + 16)
                c = page_count(-(-hi // 16) * 16, ps) * ps
                part = kp.paged_prefill_attention(
                    q[:, lo:hi].contiguous(), *arena,
                    torch.full((1,), lo, dtype=torch.int32, device=dev),
                    window_pages(table, ps, c).contiguous())
                _equal(part, whole[:, lo:hi],
                       f"paged prefill page={ps} chunk [{lo}, {hi}) "
                       f"int8={quantized} vs whole prompt")
    # serve's paged prefill chunk: 16 queries at 37.. against a 64-token
    # window in pages of 16, INT8 KV (the main path's), bf16 KV beside it
    sq, st, w, ps = 16, 37, 64, SERVE_PAGE
    arena_q, table = _paged_case(dev, ps, True, [st + sq - 1])
    arena_b, _ = _paged_case(dev, ps, False, [st + sq - 1])
    idx = window_pages(table, ps, w).contiguous()
    q = torch.randn(1, sq, hq, hd, device=dev).to(torch.bfloat16)
    start = torch.full((1,), st, dtype=torch.int32, device=dev)
    visible = sum(st + i + 1 for i in range(sq))    # causal (query, kv) pairs
    n_ops = 4 * hq * hd * visible
    seen = (st + sq) * hkv                          # the prefix the chunk sees
    io = sq * hq * hd * 2 * 2 + 4 + idx.numel() * 4  # q, out, start, table
    b_ms, by = bound(seen * hd * 2 + seen * 4 * 2 + io, n_ops, "int8")
    b16_ms, b16_by = bound(seen * hd * 2 * 2 + io, n_ops, "bf16")
    gk, gv, _, _ = _gathered(arena_b, idx)
    report["paged_prefill_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kp.paged_prefill_attention(q, *arena_q, start,
                                                      idx)),
        plain_ms=time_ms(lambda: ref.paged_prefill_attention_ref(
            q, *arena_q, start, idx)),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        bf16_kv=dict(
            ms=time_ms(lambda: kp.paged_prefill_attention(q, *arena_b, start,
                                                          idx)),
            plain_ms=time_ms(lambda: ref.paged_prefill_attention_ref(
                q, *arena_b, start, idx)),
            bound_ms=b16_ms, bound_by=b16_by,
            library_ms=_sdpa_ms(q, gk, gv, start, sq),
            library="SDPA on the gathered window, gather not timed"),
        shape=f"q (1, {sq}, {hq}, {hd}) at {st} vs INT8 arena, pages of "
              f"{ps}, window {w}")


# ------------------------------------------------------------------ serving
def phase_small_e2e(dev):
    """The smoke model on the card against the same model on the CPU (the
    plain versions): prefill + 8 decode steps, teacher-forced, INT8 KV."""
    import torch
    from repro_torch import configs
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.models import lm
    from repro_torch.weights import to_device
    cfg = configs.get_smoke_config("qwen3-0.6b")
    params = quantize_lm_params(lm.init_params(cfg, seed=0, device="cpu"))
    gpu_params = to_device(params, dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    states = {d: lm.init_decode_state(cfg, 2, 64, params=p, quantized_kv=True,
                                      device=d)
              for d, p in (("cpu", params), (dev, gpu_params))}
    toks, err = prompt, 0.0
    for step in range(9):
        out = {}
        for d, p in (("cpu", params), (dev, gpu_params)):
            out[d], states[d] = lm.decode_step(
                p, cfg, states[d], toks.to(d),
                route="prefill" if step == 0 else "decode")
        a, b = out["cpu"], out[dev].cpu()
        if a.shape != b.shape or not torch.isfinite(b).all():
            fail(f"smoke model step {step}: bad logits {tuple(b.shape)}")
        real = slice(0, cfg.vocab_size)
        err = max(err, (a[..., real] - b[..., real]).abs().max().item())
        toks = a[:, -1].argmax(-1)[:, None]
    if err > E2E_ATOL:
        fail(f"smoke model card vs CPU: max |logit diff| {err:.4g}")
    return err


def serve_once(params, cfg, dev, kernels, reqs, must, must_not,
               arrivals_s=None, arrival_ticks=None, **engine_kw):
    """One engine run from launch counts at 0: every request must equal
    serial decode token for token, every kernel in ``must`` must have
    launched and none in ``must_not``. Returns (summary, engine, launches)."""
    import torch
    from repro_torch.serving import (Engine, SchedulerConfig, serial_decode,
                                     summarize_results)
    qkv = engine_kw.get("quantized_kv", False)
    eng = Engine(params, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                                       decode_steps=SERVE_STEPS),
                 device=dev, **engine_kw)
    what = (f"int8_kv={qkv} page_size={engine_kw.get('page_size')}")
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.monotonic()
    results = eng.run(reqs, arrivals_s=arrivals_s,
                      arrival_ticks=arrival_ticks)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    if len(results) != len(reqs):
        fail(f"{what}: engine finished {len(results)} of {len(reqs)} "
             f"requests")
    for i, res in sorted(results.items()):
        n_new = reqs[i].max_new_tokens
        if len(res.tokens) != n_new or not all(
                0 <= t < cfg.vocab_size for t in res.tokens):
            fail(f"{what} request {i}: bad tokens {res.tokens}")
        want = serial_decode(params, cfg, reqs[i].prompt, n_new,
                             max_seq=SERVE_MAX_SEQ, quantized_kv=qkv,
                             device=dev)
        if res.tokens != want:
            fail(f"{what} request {i}: engine tokens differ from serial "
                 f"decode\n engine {res.tokens}\n serial {want}")
    idle = [name for name in must if launches[name] == 0]
    if idle:
        fail(f"{what}: kernels never launched on the serving run: {idle}")
    stray = [name for name in must_not if launches[name]]
    if stray:
        fail(f"{what}: kernels of the other KV layout launched: {stray}")
    return summarize_results(results, wall), eng, launches


def shared_prompt_load(cfg):
    """Request 0 is a SHARED_HEAD-token head plus a tail of 8; the other
    SHARED_N - 1 share the head, with distinct tails of 8-16 tokens, and
    arrive on the tick after request 0's prefill ends (its last chunk
    inserts the head into the prefix cache)."""
    import torch
    from repro_torch.serving import Request
    gen = torch.Generator().manual_seed(1)
    head = _tokens(cfg, SHARED_HEAD, gen)
    reqs = [Request(head + _tokens(cfg, 8 + (i * 5) % 9, gen),
                    max_new_tokens=SERVE_NEW) for i in range(SHARED_N)]
    first = -(-len(reqs[0].prompt) // SERVE_CHUNK)
    return reqs, [0] + [first] * (SHARED_N - 1)


def _tokens(cfg, n, gen):
    import torch
    return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()


def _group(name: str, kernels) -> str:
    for k in kernels:
        if k + "_kernel" in name:       # the paged twins share the body
            return "paged_" + k if "PagedAddr" in name else k
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "cublas", "xmma", "nvjet")):
        return "cublas"
    return "torch_other"


def phase_profile(params, cfg, dev, kernels):
    """Where a steady decode dispatch's time goes, contiguous against paged
    (pages of SERVE_PAGE): SERVE_SLOTS requests, all decoding, INT8 KV, one
    engine per layout on the same prompts. PROFILE_TICKS dispatches of each
    are timed on the host clock (each ends in the engine's one host sync),
    the two layouts taking turns in the order C P P C ..., so a drift of the
    shared host lands on both; then two more of each run under
    torch.profiler, whose device kernel time is summed by group. Device busy
    over host wall gives the idle share."""
    import torch
    from repro_torch.serving import Engine, Request, SchedulerConfig
    rng = torch.Generator().manual_seed(0)
    prompts = [_tokens(cfg, SERVE_PROMPT, rng) for _ in range(SERVE_SLOTS)]
    engines = {}
    for layout, page_size in (("contiguous", None), ("paged", SERVE_PAGE)):
        eng = engines[layout] = Engine(
            params, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
            sched=SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                                  decode_steps=SERVE_STEPS),
            quantized_kv=True, device=dev, page_size=page_size)
        for prompt in prompts:
            eng.submit(Request(prompt, SERVE_MAX_SEQ - SERVE_PROMPT))

    def tick(eng):
        eng.step()
        torch.cuda.synchronize(dev)

    for eng in engines.values():
        while any(slot.stage != "decode" for slot in eng.slots):
            tick(eng)
        tick(eng)                                       # warm the decode path
    wall = {layout: 0.0 for layout in engines}
    launches = {layout: dict.fromkeys(kernels, 0) for layout in engines}
    order = list(engines)
    for i in range(PROFILE_TICKS):
        for layout in (order if i % 2 == 0 else order[::-1]):
            for kern in kernels.values():
                kern.launches = 0
            t0 = time.monotonic()
            tick(engines[layout])
            wall[layout] += time.monotonic() - t0
            for n, kern in kernels.items():
                launches[layout][n] += kern.launches
    steps = PROFILE_TICKS * SERVE_STEPS
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for layout, eng in engines.items():
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            for _ in range(2):
                tick(eng)
            prof_wall_ms = (time.monotonic() - t0) * 1e3
        groups, n_kernels = {}, 0
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                g = _group(evt.name, kernels)
                groups[g] = (groups.get(g, 0.0)
                             + evt.time_range.elapsed_us() / 1e3)
                n_kernels += 1
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=15))
        busy_ms = sum(groups.values())
        prof_steps = 2 * SERVE_STEPS
        step_ms = wall[layout] / steps * 1e3
        out[layout] = {
            "decode_step_ms": step_ms,
            "tokens_per_s": SERVE_SLOTS / step_ms * 1e3,
            "port_launches_per_step": {n: c / steps for n, c
                                       in launches[layout].items()},
            "profiled_device_kernels_per_step": n_kernels / prof_steps,
            "profiled_wall_ms_per_step": prof_wall_ms / prof_steps,
            "device_busy_ms_per_step": busy_ms / prof_steps,
            "device_idle_share": (1 - busy_ms / prof_wall_ms if busy_ms
                                  else None),
            "device_ms_per_step_by_group": {
                g: v / prof_steps for g, v in sorted(groups.items())},
        }
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip().splitlines() or ["unknown"])[0]
    print(card)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import build
    from repro_torch.kernels import (decode_attention, int8_matmul,
                                     prefill_attention, quantize)
    t0 = time.monotonic()
    took = build.build()
    print(f"[build] {len(took)} libraries in {time.monotonic() - t0:.1f}s: "
          + ", ".join(f"{n} {s:.1f}s" for n, s in sorted(took.items())))
    kernels = {"quantize_rowwise": quantize.KERNEL,
               "int8_matmul": int8_matmul.KERNEL,
               "decode_attention": decode_attention.KERNEL,
               "prefill_attention": prefill_attention.KERNEL,
               "paged_decode_attention": decode_attention.PAGED_KERNEL,
               "paged_prefill_attention": prefill_attention.PAGED_KERNEL}
    report = {}
    for phase in (phase_quantize, phase_int8_matmul, phase_decode,
                  phase_prefill, phase_paged_decode, phase_paged_prefill):
        phase(dev, report)
    for name, r in report.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[kernel] {name} at {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}), max |err| "
              f"{r['max_abs_err']:.3g}  [{card}]")
        if "bf16_kv" in r:
            o = r["bf16_kv"]
            print(f"[kernel] {name} with bf16 KV: kernel {o['ms']:.4f} ms, "
                  f"plain {o['plain_ms']:.4f} ms, library "
                  f"({o.get('library', 'SDPA')}) {o['library_ms']:.4f} ms, "
                  f"bound {o['bound_ms']:.6f} ms ({o['bound_by']})  [{card}]")
    print(f"[e2e] smoke model, card vs CPU plain path: max |logit diff| "
          f"{phase_small_e2e(dev):.4g}")

    from repro_torch import configs
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models import lm
    cfg = configs.get_config("qwen3-0.6b")
    t0 = time.monotonic()
    params = quantize_lm_params(lm.init_params(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {lm.padded_vocab(cfg)}), INT8 PTQ in "
          f"{time.monotonic() - t0:.1f}s")
    contiguous = ("decode_attention", "prefill_attention")
    paged = ("paged_decode_attention", "paged_prefill_attention")
    dense = ("quantize_rowwise", "int8_matmul")
    reqs, arrivals = synth_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT,
                                    SERVE_NEW)

    def line(summary, eng, launches, label):
        print(f"[serve] {label}: {summary['n_requests']} requests, "
              f"{summary['out_tokens']} tokens, {summary['tokens_per_s']:.2f} "
              f"tok/s, TTFT p50 {summary['ttft_p50_ms']:.1f} ms, latency p50 "
              f"{summary['latency_p50_ms']:.1f} ms, "
              f"{eng.stats['device_steps']} device steps / "
              f"{eng.stats['host_syncs']} host syncs, engine == serial on "
              f"all requests, launches {launches}  [{card}]")

    main_launches = {}
    kv_bytes = None
    for quantized_kv in (True, False):
        summary, eng, launches = serve_once(
            params, cfg, dev, kernels, reqs, dense + contiguous, paged,
            arrivals_s=arrivals, quantized_kv=quantized_kv)
        if quantized_kv:
            main_launches.update({k: launches[k] for k in dense + contiguous})
            kv_bytes = eng.stats["kv_bytes"]
        line(summary, eng, launches,
             f"contiguous kv={'int8' if quantized_kv else 'bf16'}")

    # the paged path: the same staggered load, then a shared-prompt load
    summary, eng, launches = serve_once(
        params, cfg, dev, kernels, reqs, dense + paged, contiguous,
        arrivals_s=arrivals, quantized_kv=True, page_size=SERVE_PAGE)
    main_launches.update({k: launches[k] for k in paged})
    line(summary, eng, launches, f"paged kv=int8 page={SERVE_PAGE}")
    print(f"[serve] paged staggered load: pages_peak "
          f"{eng.stats['pages_peak']}, kv_bytes_peak "
          f"{eng.stats['kv_bytes_peak']} B against the contiguous pool's "
          f"{kv_bytes} B, prefix_hits {eng.stats['prefix_hits']}  [{card}]")
    shared, ticks = shared_prompt_load(cfg)
    summary, eng, launches = serve_once(
        params, cfg, dev, kernels, shared, dense + paged, contiguous,
        arrival_ticks=ticks, quantized_kv=True, page_size=SERVE_PAGE)
    line(summary, eng, launches,
         f"paged kv=int8 page={SERVE_PAGE}, shared {SHARED_HEAD}-token head")
    st = eng.stats
    n_prompt = sum(len(r.prompt) for r in shared)
    want_prefill = n_prompt - (SHARED_N - 1) * SHARED_HEAD
    if st["prefix_hits"] != SHARED_N - 1:
        fail(f"shared-prompt load: {st['prefix_hits']} prefix hits, "
             f"expected {SHARED_N - 1}")
    if st["prefill_tokens"] != want_prefill:
        fail(f"shared-prompt load: {st['prefill_tokens']} prompt tokens "
             f"prefilled, expected {want_prefill}")
    cached = len({p for v in eng.prefix._entries.values() for p in v})
    if eng.alloc.pages_in_use != cached:
        fail(f"shared-prompt load: {eng.alloc.pages_in_use} pages in use "
             f"after the run, the prefix cache holds {cached}")
    eng.alloc.check()
    eng.prefix.clear()
    if eng.alloc.pages_in_use != 0:
        fail(f"shared-prompt load: {eng.alloc.pages_in_use} pages leaked")
    print(f"[serve] shared-prompt load: prefix_hits {st['prefix_hits']}, "
          f"prefill_tokens {st['prefill_tokens']} of {n_prompt}, pages_peak "
          f"{st['pages_peak']}, kv_bytes_peak {st['kv_bytes_peak']} B against "
          f"the contiguous pool's {kv_bytes} B, {cached} pages cached after "
          f"the run, 0 after clearing the cache  [{card}]")
    for layout, prof in phase_profile(params, cfg, dev, kernels).items():
        print(f"[profile] steady decode, INT8 KV, {SERVE_SLOTS} slots, "
              f"{layout}: {json.dumps(prof)}  [{card}]")

    replaces = {"quantize_rowwise": "quantize.py:27",
                "int8_matmul": "int8_matmul.py:44",
                "decode_attention": "decode_attention.py:109",
                "prefill_attention": "prefill_attention.py:122",
                "paged_decode_attention": "decode_attention.py:155",
                "paged_prefill_attention": "prefill_attention.py:180"}
    entries = []
    for name, r in report.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kernels[name].source}.cu",
            "replaces": f"src/repro/kernels/{replaces[name]}",
            "launches": main_launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"bf16_kv": r["bf16_kv"]} if "bf16_kv" in r else {})})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
