"""Serving launcher: a fresh model, an HQP artifact built here, or a saved
artifact, through the lockstep loop or the continuous-batching engine.

  python -m repro_torch.launch.serve --smoke --device cpu --engine --hqp
  python -m repro_torch.launch.serve --engine --hqp --verify   # on the card
  python -m repro_torch.launch.serve --engine --hqp --page-size 16  # paged KV

``--hqp`` runs the whole HQP pipeline on the fresh model: a one-batch
Fisher pass (autograd through the train route), ``--prune-steps`` steps of
conditional pruning judged by next-token accuracy on the same batch,
compaction, INT8 PTQ of the linears; it prints the manifest and serves the
artifact with the INT8 KV cache; ``--save-artifact DIR`` also writes it in
the JAX package's layout. ``--load-artifact DIR`` serves an artifact that
either package saved (pruned ones included) with the INT8 KV cache.

  python -m repro_torch.launch.serve --smoke --device cpu --hqp \
      --save-artifact /tmp/art
  python -m repro_torch.launch.serve --smoke --device cpu --engine \
      --load-artifact /tmp/art

``--spec-k K`` (with ``--engine`` and a drafter from ``--hqp`` or
``--load-artifact``) serves speculatively: the artifact drafts K tokens
over its INT8 KV, the bf16 parent verifies with a bf16 KV cache, and
``--verify`` holds the output to serial decode of the parent. Under
``--load-artifact`` the parent is not on disk: the seed-0 init is made
again, loudly. ``--temperature``, ``--top-k`` and ``--seed`` sample on
every surface (the same seed, the same tokens); ``--verify`` is skipped
for a sampled speculative run, which follows the verifier's distribution,
not its token sequence.

  python -m repro_torch.launch.serve --smoke --device cpu --engine --hqp \
      --spec-k 4 --verify
  python -m repro_torch.launch.serve --smoke --device cpu --engine \
      --temperature 0.8 --top-k 50 --seed 7

``--engine`` serves ``--batch`` staggered synthetic requests, or replays a
JSONL request trace (``--trace``). ``--http`` serves live requests instead:
the engine behind the HTTP/1.1 front door (``serving.service``), tokens
streamed as server-sent events, with bounded admission (``--queue-depth``),
deadlines (``--deadline-s``, per request ``deadline_s``), deadline-
feasibility shedding (off with ``--no-feasibility``), a pump watchdog
(``--watchdog-s``), Prometheus ``GET /metrics``, and a drain on SIGTERM.
``--trace-dir`` writes the engine's spans (Chrome trace and JSONL) after
the run, ``--profile-dir`` a ``torch.profiler`` Chrome trace of it.

  python -m repro_torch.launch.serve --smoke --device cpu --engine --http \
      --port 8080 --page-size 16 --no-prefix-cache
  curl -N -d '{"prompt_len": 8, "max_new_tokens": 4}' \
      http://127.0.0.1:8080/v1/generate"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device, telemetry, tree
from repro_torch.compress.artifact import HQPArtifact, compress
from repro_torch.core.pipeline import HQPConfig
from repro_torch.core.sensitivity import fisher_diag, loss_grad_fn
from repro_torch.launch.checkpoint import load_artifact, save_artifact
from repro_torch.models import lm
from repro_torch.serving import (AdmissionController, Engine, Request,
                                 SchedulerConfig, serial_decode,
                                 summarize_results)
from repro_torch.serving import sampling as smp
from repro_torch.train.train_step import make_eval_step


def synth_requests(cfg, n: int, prompt_len: int, max_new_tokens: int,
                   gap_s: float = 0.02, seed: int = 0):
    """Staggered synthetic load: varying prompt lengths so chunked prefill
    interleaves with decode of earlier requests."""
    rng = np.random.RandomState(seed)
    lens = [max(4, prompt_len + (i * 7) % 11 - 5) for i in range(n)]
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, n_tok).tolist(),
                    max_new_tokens=max_new_tokens) for n_tok in lens]
    return reqs, [i * gap_s for i in range(n)]


def _calib_batch(cfg, batch: int, seq: int, device, seed: int = 17) -> dict:
    rng = np.random.RandomState(seed)
    b = {"tokens": torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (batch, seq)), dtype=torch.long,
        device=device)}
    if cfg.n_frontend:
        b["embeds"] = lm.frontend_embeds(cfg, batch, device)
    return b


def build_artifact(params, cfg, prune_steps: int,
                   log=print) -> HQPArtifact:
    """HQP artifact for serving, as the JAX package's launcher builds it: a
    one-batch Fisher pass and a next-token-accuracy eval on the same batch
    drive the conditional prune (δ = 5 % of the units a step, at most
    ``prune_steps`` steps), then compaction and PTQ. The artifact's
    ``seconds`` hold each stage's time: "fisher", "evals" (the baseline,
    then one per prune step), "compact", "ptq"."""
    device = tree.leaves(params)[0].device
    batch = _calib_batch(cfg, batch=2, seq=32, device=device)
    t0 = time.time()
    sq, _ = fisher_diag(loss_grad_fn(lambda p, b: lm.loss_fn(p, cfg, b)),
                        params, [batch])
    tree.synchronize(sq)
    fisher_s = time.time() - t0
    eval_step = make_eval_step(cfg)
    evals = []

    def eval_fn(p):
        t0 = time.time()
        acc = float(eval_step(p, batch))
        evals.append(time.time() - t0)
        return acc

    hqp = HQPConfig(step_frac=0.05, max_steps=prune_steps)
    art = compress(params, cfg, sq_grads=sq, eval_fn=eval_fn, hqp=hqp,
                   log=log)
    art.seconds.update(fisher=fisher_s, evals=evals)
    log(f"[hqp] stage seconds: Fisher {fisher_s:.2f}, evals "
        f"{' '.join(f'{t:.2f}' for t in evals)}, compact "
        f"{art.seconds['compact']:.2f}, PTQ {art.seconds['ptq']:.2f}")
    return art


def acquire_params(args, cfg, device, log=print):
    """(params, quantized_kv, manifest, parent): a loaded artifact (its
    parent None: not on disk), an HQP artifact built from a fresh seed-0
    init (``--hqp``, written to ``--save-artifact`` when given; the parent
    is that init), or a fresh bf16 init (no manifest, no parent)."""
    if args.load_artifact:
        art = load_artifact(args.load_artifact, device=device)
        if art.manifest.arch != cfg.name:
            raise SystemExit(
                f"artifact was built for {art.manifest.arch!r}, requested "
                f"config is {cfg.name!r} — pass the matching --arch/--smoke")
        log(f"[serve] loaded artifact {args.load_artifact}")
        log(art.manifest.summary())
        return art.params, True, art.manifest, None
    params = lm.init_params(cfg, seed=0, device=device)
    if args.hqp:
        art = build_artifact(params, cfg, args.prune_steps, log=log)
        log(art.manifest.summary())
        if args.save_artifact:
            log(f"[serve] artifact saved to "
                f"{save_artifact(args.save_artifact, art)}")
        return art.params, True, art.manifest, params
    return params, False, None, None


# ------------------------------------------------------------------ engine
def _attach_tracer(eng, trace_dir):
    """A span recorder on the engine when ``--trace-dir`` asks for one: a
    passive sink the engine stamps with its own clock."""
    if not trace_dir:
        return None
    eng.tracer = telemetry.SpanRecorder()
    return eng.tracer


def _write_tracer(tracer, trace_dir, log):
    if tracer is None:
        return
    trace_path, jsonl_path = telemetry.write_trace(trace_dir, tracer)
    log(f"[trace] wrote {trace_path} (Perfetto/chrome://tracing) and "
        f"{jsonl_path}")


def _profiler(profile_dir, device):
    """``--profile-dir``: a ``torch.profiler`` (not started) to run over
    the engine's work, the card's kernels included on CUDA. A profiler
    that fails raises."""
    if not profile_dir:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _write_profile(prof, profile_dir, log) -> None:
    if prof is None:
        return
    path = pathlib.Path(profile_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "profile.json"))
    log(f"[profile] torch.profiler trace written to {path / 'profile.json'}")


def load_trace(path: str, cfg, seed: int = 0):
    """JSONL request trace: one object per line with ``arrival_s`` (float,
    offset from replay start) and either ``prompt`` (token ids) or
    ``prompt_len`` (synthesized from ``seed``); optional ``max_new_tokens``
    (default 16) and ``eos_id``."""
    rng = np.random.RandomState(seed)
    reqs, arrivals = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "prompt" in d:
                prompt = d["prompt"]
                if not prompt:
                    raise ValueError(f"trace line has an empty prompt: {d}")
            elif "prompt_len" in d:
                prompt = rng.randint(
                    0, cfg.vocab_size, int(d["prompt_len"])).tolist()
            else:
                raise ValueError(
                    f"trace line needs 'prompt' or 'prompt_len': {d}")
            reqs.append(Request(prompt=prompt,
                                max_new_tokens=int(d.get("max_new_tokens",
                                                         16)),
                                eos_id=d.get("eos_id")))
            arrivals.append(float(d.get("arrival_s", 0.0)))
    return reqs, arrivals


def build_engine(params, cfg, args, quantized_kv: bool, device,
                 sampling=None, draft=None) -> Engine:
    """One Engine from the serve flags, shared by the synthetic or trace
    replay (``run_engine``) and the HTTP front door (``serve_http``).
    ``draft`` = (draft params, manifest) makes it speculative."""
    return Engine(params, cfg, n_slots=args.engine_slots,
                  max_seq=args.max_seq,
                  sched=SchedulerConfig(prefill_chunk=args.prefill_chunk,
                                        decode_steps=args.decode_steps),
                  quantized_kv=quantized_kv, device=device,
                  page_size=args.page_size or None,
                  total_pages=args.total_pages or None,
                  prefix_cache=not args.no_prefix_cache, sampling=sampling,
                  **({} if draft is None else dict(
                      draft_params=draft[0], draft_manifest=draft[1],
                      spec_k=args.spec_k)))


def serve_http(params, cfg, args, quantized_kv: bool, device, log=print,
               sampling=None, draft=None):
    """``serve --http``: the engine behind the SSE front door, until
    SIGTERM or SIGINT, then a drain of the requests in flight. Before it
    listens, one warm-up request runs twice: its first run makes each of
    its dispatch keys' eager first use, the second their capture (on the
    card), so the first client's TTFT measures serving. The warm-up's
    counters are then zeroed."""
    from repro_torch.serving.service import Service, ServiceConfig, run_http
    eng = build_engine(params, cfg, args, quantized_kv, device,
                       sampling=sampling, draft=draft)
    t0 = time.monotonic()
    for _ in range(2):
        eng.run([Request(prompt=[3, 1, 4, 1, 5, 9], max_new_tokens=2)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"[http] warm-up: {time.monotonic() - t0:.1f}s, "
        f"{eng.stats['eager_dispatches']} eager dispatches, "
        f"{eng.stats['graphs_captured']} CUDA graphs captured")
    for key, (kind, _) in telemetry.schema.ENGINE_STATS.items():
        if kind == "counter" and key in eng.stats:
            eng.stats[key] = type(eng.stats[key])(0)
    admission = None if args.no_feasibility else AdmissionController()
    svc = Service(eng, ServiceConfig(queue_depth=args.queue_depth,
                                     default_deadline_s=args.deadline_s),
                  admission=admission)
    # attached after the warm-up: the trace starts at the first client's
    # submit
    tracer = _attach_tracer(eng, args.trace_dir)
    # the profiler runs on the pump thread, where the engine's work runs
    prof = _profiler(args.profile_dir, device)
    run_http(svc, host=args.host, port=args.port, log=log,
             watchdog_s=args.watchdog_s or None, pump_context=prof)
    _write_profile(prof, args.profile_dir, log)
    _write_tracer(tracer, args.trace_dir, log)
    return svc


def run_engine(params, cfg, args, quantized_kv: bool, device, log=print,
               sampling=None, draft=None):
    """``draft`` = (draft params, manifest) makes the engine speculative:
    ``params`` are then the bf16 verifier (``quantized_kv`` its KV) and the
    drafter keeps INT8 KV. ``--verify`` compares with serial decode of
    ``params``, which greedy speculative output equals when its one-token
    steps take the prefill route, as the verify pass does (on the CPU
    both routes give the same bits, on the card near ties may break
    apart)."""
    if args.trace:
        reqs, arrivals = load_trace(args.trace, cfg)
        log(f"[engine] replaying trace {args.trace}: {len(reqs)} requests")
    else:
        n = max(3, args.batch)
        reqs, arrivals = synth_requests(cfg, n, args.prompt_len, args.tokens)
        log(f"[engine] synthetic load: {n} staggered requests")
    if not reqs:
        raise SystemExit("[engine] trace contains no requests")
    need = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    if need > args.max_seq:
        raise SystemExit(f"requests need max-seq >= {need}, "
                         f"got {args.max_seq}")
    eng = build_engine(params, cfg, args, quantized_kv, device,
                       sampling=sampling, draft=draft)
    tracer = _attach_tracer(eng, args.trace_dir)
    prof = _profiler(args.profile_dir, device)
    if prof is not None:
        prof.start()
    t0 = time.monotonic()
    results = eng.run(reqs, arrivals_s=arrivals)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    if prof is not None:
        prof.stop()
    _write_profile(prof, args.profile_dir, log)
    _write_tracer(tracer, args.trace_dir, log)
    stats = {**summarize_results(results, wall), **eng.stats}
    stats["acceptance_rate"] = (eng.stats["accepted_tokens"]
                                / max(eng.stats["drafted_tokens"], 1))
    log(f"[engine] {stats['n_requests']} requests in {wall * 1000:.0f}ms on "
        f"{device}: {stats['tokens_per_s']:.1f} tok/s, latency p50/p95 "
        f"{stats['latency_p50_ms']:.0f}/{stats['latency_p95_ms']:.0f}ms, "
        f"ttft p50/p95 {stats['ttft_p50_ms']:.0f}/"
        f"{stats['ttft_p95_ms']:.0f}ms ({eng.stats['device_steps']} device "
        f"decode steps / {eng.stats['host_syncs']} host syncs, "
        f"{eng.stats['graphs_captured']} CUDA graphs captured / "
        f"{eng.stats['graph_replays']} replays"
        + (f", spec acceptance {stats['acceptance_rate']:.2f} "
           f"({eng.stats['accepted_tokens']} of "
           f"{eng.stats['drafted_tokens']} drafts)" if draft else "")
        + (f", {eng.stats['prefix_hits']} prefix hits / "
           f"{eng.stats['pages_peak']} pages peak" if args.page_size else "")
        + (", no prefix cache: the pattern has recurrent layers"
           if eng.paged and eng.recurrent and not args.no_prefix_cache
           else "")
        + ")")
    verify = args.verify if args.verify is not None else args.smoke
    if verify and draft is not None and not eng.sampling.is_greedy:
        log("[engine] verify skipped: speculative sampling follows the "
            "verifier's distribution, not its token sequence (greedy "
            "speculative output is token-identical and verified)")
        verify = False
    if verify:
        bad = [i for i, res in sorted(results.items())
               if res.tokens != serial_decode(
                   params, cfg, reqs[i].prompt, reqs[i].max_new_tokens,
                   max_seq=args.max_seq, eos_id=reqs[i].eos_id,
                   quantized_kv=quantized_kv, device=device,
                   sampling=sampling,
                   route="decode" if draft is None else "prefill")]
        if bad:
            raise SystemExit(f"[engine] VERIFY FAILED: requests {bad} differ "
                             f"from serial single-request decode")
        log(f"[engine] verify: all {len(results)} outputs token-identical "
            f"to serial decode")
    return results, stats


@dataclasses.dataclass
class Lockstep:
    """What ``lockstep`` returns: the tokens (B, n_new) on the host, the
    prefill's last-position logits (B, V), the prefill's and the decode
    steps' seconds (synchronised) and the KV cache's bytes."""
    tokens: np.ndarray
    first_logits: torch.Tensor
    prefill_s: float
    decode_s: float
    kv_bytes: int


def lockstep(params, cfg, prompts: torch.Tensor, n_new: int, max_seq: int,
             quantized_kv: bool, device, embeds=None,
             sampling=None) -> Lockstep:
    """One batch of equal-length ``prompts`` (B, S): a prefill, of
    ``embeds`` (B, n_fr, d) before the prompt when the config has a
    frontend, then ``n_new`` - 1 decode steps, greedy or drawn with the
    engine's key rule (the token's position in the text: a frontend's
    positions do not count)."""
    scfg = sampling or smp.GREEDY
    base = smp.base_key(scfg, device)
    cuda = torch.device(device).type == "cuda"

    def pick(logits, pos: int) -> torch.Tensor:
        at = torch.full((logits.shape[0],), pos, device=device)
        return smp.sample_batch(logits[:, -1], scfg, base, at)[:, None]

    def clock() -> float:
        if cuda:
            torch.cuda.synchronize(device)
        return time.monotonic()

    state = lm.init_decode_state(cfg, prompts.shape[0], max_seq,
                                 params=params, quantized_kv=quantized_kv,
                                 device=device)
    t0 = clock()
    logits, state = lm.decode_step(params, cfg, state, prompts,
                                   route="prefill", embeds=embeds)
    t1 = clock()
    first = logits[:, -1].clone()
    pos = prompts.shape[1]
    tok = pick(logits, pos)
    outputs = [tok]
    for _ in range(n_new - 1):
        logits, state = lm.decode_step(params, cfg, state, tok,
                                       route="decode")
        pos += 1
        tok = pick(logits, pos)
        outputs.append(tok)
    out = torch.cat(outputs, dim=1).cpu().numpy()
    kv = sum(t.numel() * t.element_size()
             for t in tree.leaves(state["caches"]))
    return Lockstep(out, first, t1 - t0, clock() - t1, kv)


def run_lockstep(params, cfg, args, quantized_kv: bool, device, log=print,
                 sampling=None):
    """The launcher's lockstep batch (``lockstep``): ``args.batch``
    prompts of ``args.prompt_len`` tokens from ``RandomState(0)``, after
    the launcher's zero embeddings when the config has a frontend, as the
    JAX package's launcher does. Returns the tokens."""
    rng = np.random.RandomState(0)
    prompts = torch.as_tensor(rng.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)), device=device)
    embeds = (lm.frontend_embeds(cfg, args.batch, device)
              if cfg.n_frontend else None)
    run = lockstep(params, cfg, prompts, args.tokens, args.max_seq,
                   quantized_kv, device, embeds=embeds, sampling=sampling)
    log(f"[serve] decode {args.tokens - 1} steps on {device}: "
        f"{args.batch * (args.tokens - 1) / max(run.decode_s, 1e-9):.1f} "
        f"tok/s")
    log(f"[serve] sample continuation (req 0): {run.tokens[0][:16]}")
    return run.tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests of the lockstep batch, and of the "
                         "engine's synthetic load (at least 3)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--hqp", action="store_true",
                    help="HQP: Fisher pass, conditional pruning, "
                         "compaction, INT8 PTQ; INT8 KV cache")
    ap.add_argument("--prune-steps", type=int, default=3,
                    help="at most this many conditional prune steps of 5 %% "
                         "of the units each (--hqp)")
    ap.add_argument("--save-artifact", default=None,
                    help="directory to write the --hqp artifact to (atomic)")
    ap.add_argument("--load-artifact", default=None,
                    help="serve an artifact saved by either package")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine instead of the "
                         "single-batch lockstep loop")
    ap.add_argument("--engine-slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=4,
                    help="batched decode steps per host sync")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: arena page size in tokens (engine "
                         "mode; 0 = contiguous per-slot pool). Outputs are "
                         "token-identical at every page size")
    ap.add_argument("--total-pages", type=int, default=0,
                    help="paged KV arena size in pages (0 = full "
                         "provisioning, 1 + slots*ceil(max_seq/page_size))")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix page reuse (paged mode)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft length: the HQP artifact drafts "
                         "K tokens a cycle, its bf16 parent verifies "
                         "(needs --engine and --hqp or --load-artifact; 0 = "
                         "off)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy, the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling cutoff (0 = the whole vocabulary)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed: the same seed gives the same "
                         "tokens, engine and serial alike")
    ap.add_argument("--trace", default=None,
                    help="JSONL request trace to replay (engine mode): "
                         "arrival_s, prompt or prompt_len, max_new_tokens, "
                         "eos_id a line")
    ap.add_argument("--trace-dir", default=None,
                    help="write the engine's per-request spans here after "
                         "the run: trace.json (Chrome trace-event JSON, for "
                         "Perfetto or chrome://tracing) and spans.jsonl")
    ap.add_argument("--profile-dir", default=None,
                    help="run the engine under torch.profiler and write its "
                         "Chrome trace here (profile.json)")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP with SSE token streaming instead "
                         "of a synthetic load or a trace (implies --engine; "
                         "blocks until SIGTERM, then drains the requests "
                         "in flight)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="HTTP bind address (--http)")
    ap.add_argument("--port", type=int, default=8080,
                    help="HTTP bind port; 0 picks a free port (--http)")
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="admission bound beyond the slots: past slots + "
                         "depth requests in flight a submit is shed with 429 "
                         "(--http)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline in seconds; an "
                         "expired request is evicted wherever it is and "
                         "streams finish_reason=deadline (--http; a "
                         "request's 'deadline_s' wins)")
    ap.add_argument("--no-feasibility", action="store_true",
                    help="no deadline-feasibility admission (the EWMA "
                         "throughput predictor that sheds a deadlined "
                         "request it cannot serve in time); the static "
                         "slots + queue-depth bound always holds")
    ap.add_argument("--watchdog-s", type=float, default=300.0,
                    help="pump watchdog: if the engine thread makes no "
                         "progress for this long the server exits 2 "
                         "instead of hanging (0 = off; --http). On the "
                         "card a dispatch key's first use runs eagerly "
                         "(~50-75 ms at full width) and its second "
                         "captures a CUDA graph (~0.15 s), so a value of "
                         "seconds or less fires on a cold server")
    ap.add_argument("--verify", action="store_true", default=None,
                    help="check engine outputs == serial decode "
                         "(default: on under --smoke)")
    args = ap.parse_args(argv)
    if args.http:
        args.engine = True           # the front door is an engine transport
        if args.trace:
            ap.error("--http serves live requests; --trace replays a file — "
                     "pick one")
    if (args.trace_dir or args.profile_dir or args.trace) \
            and not args.engine:
        ap.error("--trace/--trace-dir/--profile-dir need --engine")
    if args.hqp and args.load_artifact:
        ap.error("--hqp builds an artifact; --load-artifact loads one — "
                 "pick one")
    if args.save_artifact and not args.hqp:
        ap.error("--save-artifact requires --hqp (nothing to save otherwise)")
    if args.page_size and not args.engine:
        ap.error("--page-size needs --engine (the lockstep loop has no "
                 "slot pool to page)")
    if args.spec_k:
        if not args.engine:
            ap.error("--spec-k needs --engine (speculation is an engine "
                     "decode mode)")
        if not (args.hqp or args.load_artifact):
            ap.error("--spec-k needs a drafter: pass --hqp (build one) or "
                     "--load-artifact")
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    # the lockstep batch writes its frontend positions, its prompt and
    # every new token but the last, which is never fed back
    need = cfg.n_frontend + args.prompt_len + args.tokens - 1
    if not args.engine and need > args.max_seq:
        ap.error(f"the lockstep batch needs --max-seq >= {need} "
                 f"({cfg.n_frontend} frontend positions + --prompt-len "
                 f"{args.prompt_len} + --tokens {args.tokens} - 1), got "
                 f"{args.max_seq}")
    device = resolve_device(args.device)
    sampling = smp.SamplingConfig(temperature=args.temperature,
                                  top_k=args.top_k, seed=args.seed)
    params, quantized_kv, manifest, parent = acquire_params(args, cfg,
                                                            device)
    if args.engine:
        draft = None
        if args.spec_k:
            if parent is None:
                # the artifact's parent is not on disk: make the seed-0
                # init again (the manifest's arch hash still guards the
                # architecture). Loud on purpose: an artifact built from
                # other weights (another seed, a trained checkpoint) gets
                # an unrelated verifier, whose output stays its own but
                # accepts almost no draft
                print("[serve] WARNING: --spec-k with --load-artifact "
                      "makes the seed-0 bf16 parent again as the verifier; "
                      "if the artifact was built from other weights, "
                      "expect near-zero acceptance (pass --hqp to build "
                      "drafter and verifier from the same params)")
                parent = lm.init_params(cfg, seed=0, device=device)
            draft = (params, manifest)
            params, quantized_kv = parent, False    # the bf16 verifier
        if args.http:
            return serve_http(params, cfg, args, quantized_kv, device,
                              sampling=sampling, draft=draft).stats
        return run_engine(params, cfg, args, quantized_kv, device,
                          sampling=sampling, draft=draft)[1]
    return run_lockstep(params, cfg, args, quantized_kv, device,
                        sampling=sampling)


if __name__ == "__main__":
    main()
