#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card: build the CUDA
kernels, hold each against its plain PyTorch version at the shapes of the
serving path, then serve the full-width qwen3-0.6b (random weights from a
seed, INT8 PTQ) through the continuous-batching engine and check it against
serial decode; last, profile a steady decode dispatch (where its time goes
on the card).

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


def serve_once(params, cfg, dev, quantized_kv, kernels):
    import torch
    from repro_torch.launch.serve import synth_requests
    from repro_torch.serving import (Engine, SchedulerConfig, serial_decode,
                                     summarize_results)
    reqs, arrivals = synth_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT,
                                    SERVE_NEW)
    eng = Engine(params, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                                       decode_steps=SERVE_STEPS),
                 quantized_kv=quantized_kv, device=dev)
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.monotonic()
    results = eng.run(reqs, arrivals_s=arrivals)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    if len(results) != len(reqs):
        fail(f"engine finished {len(results)} of {len(reqs)} requests")
    for i, res in sorted(results.items()):
        if len(res.tokens) != SERVE_NEW or not all(
                0 <= t < cfg.vocab_size for t in res.tokens):
            fail(f"request {i}: bad tokens {res.tokens}")
        want = serial_decode(params, cfg, reqs[i].prompt, SERVE_NEW,
                             max_seq=SERVE_MAX_SEQ, quantized_kv=quantized_kv,
                             device=dev)
        if res.tokens != want:
            fail(f"int8_kv={quantized_kv} request {i}: engine tokens differ "
                 f"from serial decode\n engine {res.tokens}\n serial {want}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        fail(f"kernels never launched on the serving run: {idle}")
    return summarize_results(results, wall), eng.stats, launches


def _group(name: str, kernels) -> str:
    for k in kernels:
        if k + "_kernel" in name:
            return k
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "cublas", "xmma", "nvjet")):
        return "cublas"
    return "torch_other"


def phase_profile(params, cfg, dev, kernels):
    """Where a steady decode dispatch's time goes: SERVE_SLOTS requests, all
    decoding, INT8 KV. PROFILE_TICKS dispatches are timed on the host clock
    (each ends in the engine's one host sync); two more run under
    torch.profiler, whose device kernel time is summed by group. Device busy
    over host wall gives the idle share."""
    import torch
    from repro_torch.serving import Engine, Request, SchedulerConfig
    eng = Engine(params, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                                       decode_steps=SERVE_STEPS),
                 quantized_kv=True, device=dev)
    rng = torch.Generator().manual_seed(0)
    for _ in range(SERVE_SLOTS):
        eng.submit(Request(torch.randint(0, cfg.vocab_size, (SERVE_PROMPT,),
                                         generator=rng).tolist(),
                           max_new_tokens=SERVE_MAX_SEQ - SERVE_PROMPT))

    def tick():
        eng.step()
        torch.cuda.synchronize(dev)

    while any(slot.stage != "decode" for slot in eng.slots):
        tick()
    tick()                                              # warm the decode path
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.monotonic()
    for _ in range(PROFILE_TICKS):
        tick()
    steps = PROFILE_TICKS * SERVE_STEPS
    step_ms = (time.monotonic() - t0) / steps * 1e3
    launches = {n: kern.launches / steps for n, kern in kernels.items()}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(2):
            tick()
        prof_wall_ms = (time.monotonic() - t0) * 1e3
    groups, n_kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            g = _group(evt.name, kernels)
            groups[g] = groups.get(g, 0.0) + evt.time_range.elapsed_us() / 1e3
            n_kernels += 1
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15))
    busy_ms = sum(groups.values())
    prof_steps = 2 * SERVE_STEPS
    return {
        "decode_step_ms": step_ms,
        "tokens_per_s": SERVE_SLOTS / step_ms * 1e3,
        "port_launches_per_step": launches,
        "profiled_device_kernels_per_step": n_kernels / prof_steps,
        "profiled_wall_ms_per_step": prof_wall_ms / prof_steps,
        "device_busy_ms_per_step": busy_ms / prof_steps,
        "device_idle_share": 1 - busy_ms / prof_wall_ms if busy_ms else None,
        "device_ms_per_step_by_group": {g: v / prof_steps
                                        for g, v in sorted(groups.items())},
    }


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
               "prefill_attention": prefill_attention.KERNEL}
    report = {}
    for phase in (phase_quantize, phase_int8_matmul, phase_decode,
                  phase_prefill):
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
                  f"plain {o['plain_ms']:.4f} ms, library (SDPA) "
                  f"{o['library_ms']:.4f} ms, bound {o['bound_ms']:.6f} ms "
                  f"({o['bound_by']})  [{card}]")
    print(f"[e2e] smoke model, card vs CPU plain path: max |logit diff| "
          f"{phase_small_e2e(dev):.4g}")

    from repro_torch import configs
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.models import lm
    cfg = configs.get_config("qwen3-0.6b")
    t0 = time.monotonic()
    params = quantize_lm_params(lm.init_params(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {lm.padded_vocab(cfg)}), INT8 PTQ in "
          f"{time.monotonic() - t0:.1f}s")
    main_launches = None
    for quantized_kv in (True, False):
        summary, stats, launches = serve_once(params, cfg, dev, quantized_kv,
                                              kernels)
        if quantized_kv:
            main_launches = launches
        print(f"[serve] kv={'int8' if quantized_kv else 'bf16'}: "
              f"{summary['n_requests']} requests, {summary['out_tokens']} "
              f"tokens, {summary['tokens_per_s']:.2f} tok/s, TTFT p50 "
              f"{summary['ttft_p50_ms']:.1f} ms, latency p50 "
              f"{summary['latency_p50_ms']:.1f} ms, {stats['device_steps']} "
              f"device steps / {stats['host_syncs']} host syncs, engine == "
              f"serial on all requests, launches {launches}  [{card}]")
    print(f"[profile] steady decode, INT8 KV, {SERVE_SLOTS} slots: "
          f"{json.dumps(phase_profile(params, cfg, dev, kernels))}  [{card}]")

    replaces = {"quantize_rowwise": "quantize.py:27",
                "int8_matmul": "int8_matmul.py:44",
                "decode_attention": "decode_attention.py:109",
                "prefill_attention": "prefill_attention.py:122"}
    entries = []
    for name, r in report.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
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
