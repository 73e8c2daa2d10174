"""The paper's own experiment: HQP on ResNet-18 and MobileNetV3-Small
(Tables I/II), the JAX package's ``run_experiment`` on the port.

Per architecture:
  1. train the CNN on the deterministic synthetic dataset to a solid
     baseline (SGD with momentum, cosine learning rate);
  2. a Fisher pass over D_calib (one backward pass a batch, §II-B);
  3. methods:
       Q8-only  — per-tensor weight fake-quant + KL-calibrated activations
       P50-only — L1-magnitude structural pruning at fixed θ = 50 % (no
                  guarantee)
       HQP      — Algorithm 1 conditional prune (Δ_ax = 1.5 %) -> robust PTQ
  4. metrics: top-1 accuracy drop (on the held-out val set), model size
     (INT8 storage accounting), measured latency of the *compacted* model
     at batch 64, and a modeled latency on one H100 SXM (roofline:
     max(FLOPs / peak, bytes / HBM rate), INT8 at twice the bf16 peak and
     half the weight bytes).

On the card a measured latency is the median of 30 synchronised replays of
a CUDA graph that captured the eval forward once (the counterpart of the
reference's one jitted call), with the eager forward's median beside it; on
the CPU both are the eager forward's. The FLOP count of the modeled latency
is the port's own, from shapes (``models.cnn.forward_cost``), equal to XLA's
cost analysis of the reference's forward within 1 %.

    python -m repro_torch.repro_exp.cnn_experiment --arch both
    python -m repro_torch.repro_exp.cnn_experiment --device cpu --width 0.25 \\
        --steps 20 --ntrain 512 --nval 500
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import pathlib
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.compress.artifact import compress
from repro_torch.configs import get_cnn_config
from repro_torch.core import calibration as calib
from repro_torch.core import pipeline as pipe
from repro_torch.core import pruning as pr
from repro_torch.core import sensitivity as sens
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.models import cnn
from repro_torch.roofline.hardware import H100_SXM


# Algorithm 1's settings in the HQP row (the reference's): δ = 2 % of the
# units a step, at most 60 steps, simulated INT8
ALGORITHM1 = pipe.HQPConfig(step_frac=0.02, max_steps=60, track="fake")


def to_tensors(batch: dict, device) -> dict:
    """A numpy batch of ``SyntheticImages`` as tensors on ``device``."""
    return {"image": torch.from_numpy(batch["image"]).to(device),
            "label": torch.from_numpy(batch["label"]).long().to(device)}


def _device(variables) -> torch.device:
    return tree.leaves(variables)[0].device


# ------------------------------------------------------------------ training
def ce_loss(cfg, variables, batch, train=True):
    logits, new_stats = cnn.cnn_apply(cfg, variables, batch["image"], train)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["label"][:, None])[:, 0]
    return (lse - gold).mean(), new_stats


def cosine_lr(lr: float, i: int, steps: int) -> float:
    """The step's learning rate, rounded to f32 as the reference passes it."""
    return float(np.float32(lr * 0.5 * (1 + np.cos(np.pi * i / steps))))


def sgd_step(cfg, variables: dict, velocity, batch: dict, lr_t: float):
    """One momentum-SGD step, the reference's: ``v = 0.9·v + g``, ``p -=
    lr_t·v``, the BN statistics those of the training forward. Updates
    ``velocity`` and the params in place; returns the new variables (the
    same params, the new stats) and the loss."""
    aux = {}

    def loss(params, b):
        value, aux["stats"] = ce_loss(
            cfg, {"params": params, "stats": variables["stats"]}, b)
        return value

    value, grads = sens.value_and_grad(loss)(variables["params"], batch)
    with torch.no_grad():
        v, p = tree.leaves(velocity), tree.leaves(variables["params"])
        torch._foreach_mul_(v, 0.9)
        torch._foreach_add_(v, tree.leaves(grads))
        torch._foreach_sub_(p, torch._foreach_mul(v, lr_t))
    return {"params": variables["params"], "stats": aux["stats"]}, value


def train_cnn(cfg, data: SyntheticImages, steps: int = 400,
              batch_size: int = 128, lr: float = 0.2, log=print,
              device=None) -> dict:
    """The reference's training run: weights from seed 0, batches of
    ``data`` shuffled by seed 1, cosine decay of ``lr`` over ``steps``."""
    device = resolve_device(device)
    variables = cnn.cnn_init(cfg, torch.Generator().manual_seed(0), device)
    velocity = tree.map_(torch.zeros_like, variables["params"])
    it = data.batches(batch_size, seed=1, epochs=1000)
    t0 = time.time()
    for i in range(steps):
        variables, loss = sgd_step(cfg, variables, velocity,
                                   to_tensors(next(it), device),
                                   cosine_lr(lr, i, steps))
        if i % 100 == 0 or i == steps - 1:
            log(f"  [train {cfg.arch}] step {i} loss={float(loss):.4f} "
                f"({time.time()-t0:.0f}s)")
    return variables


def make_eval_fn(cfg, val: SyntheticImages, batch_size: int = 250,
                 actq: Optional[calib.ActQ] = None,
                 device=None) -> Callable:
    """variables -> top-1 accuracy on ``val`` (its batches moved to
    ``device`` once; one host sync per call)."""
    batches = [to_tensors(b, resolve_device(device))
               for b in val.batches(batch_size)]

    def eval_fn(variables) -> float:
        correct = 0
        with torch.no_grad():
            for b in batches:
                logits, _ = cnn.cnn_apply(cfg, variables, b["image"],
                                          train=False, actq=actq)
                correct = correct + (logits.argmax(-1) == b["label"]).sum()
        return int(correct) / (len(batches) * batch_size)
    return eval_fn


# ------------------------------------------------------------------ fisher
def fisher_for(cfg, variables, calib_data: SyntheticImages,
               batch_size: int = 100):
    """E[g²] of the eval-mode loss over ``calib_data``, in the full
    variables' layout (specs address ``("params", ...)``; stats get 0)."""
    device = _device(variables)
    grad_fn = sens.loss_grad_fn(lambda p, b: ce_loss(
        cfg, {"params": p, "stats": variables["stats"]}, b, train=False)[0])
    sq, _ = sens.fisher_diag(
        grad_fn, variables["params"],
        (to_tensors(b, device) for b in calib_data.batches(batch_size)))
    return {"params": sq,
            "stats": tree.map_(torch.zeros_like, variables["stats"])}


# ------------------------------------------------------------------ PTQ
def calibrate_activations(cfg, variables, calib_data: SyntheticImages,
                          method: str = "kl", n_batches: int = 4) -> calib.ActQ:
    device = _device(variables)
    actq = calib.ActQ(mode="amax", method=method)
    batches = [to_tensors(b, device)
               for b in list(calib_data.batches(100))[:n_batches]]
    with torch.no_grad():
        for b in batches:                  # pass 1: ranges
            cnn.cnn_apply(cfg, variables, b["image"], train=False, actq=actq)
        actq.mode = "hist"
        for b in batches:                  # pass 2: histograms
            cnn.cnn_apply(cfg, variables, b["image"], train=False, actq=actq)
    return actq.finalize()


# ------------------------------------------------------------------ latency
def _median_ms(fn: Callable[[], object], iters: int,
               device: torch.device) -> float:
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    fn()
    sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1000)


def measured_latency_ms(cfg, variables, batch: int = 64, iters: int = 30,
                     image_size: int = 32) -> Dict[str, float]:
    """``{"ms", "eager_ms"}`` of the eval forward of ``batch`` images on
    the variables' device, medians of ``iters`` synchronised calls. On the
    card ``ms`` replays a CUDA graph that captured the forward once; on
    the CPU it is the eager forward's time."""
    device = _device(variables)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        batch, image_size, image_size, 3).astype(np.float32)).to(device)

    def forward():
        return cnn.cnn_apply(cfg, variables, x, train=False)[0]

    with torch.no_grad():
        eager = _median_ms(forward, iters, device)
        if device.type != "cuda":
            return {"ms": eager, "eager_ms": eager}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            forward()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a collection inside the capture could free another graph's
        # memory, which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                forward()
        finally:
            if collecting:
                gc.enable()
        ms = _median_ms(graph.replay, iters, device)
    return {"ms": ms, "eager_ms": eager}


def modeled_latency_ms(cfg, variables, int8: bool, batch: int = 64,
                       image_size: int = 32) -> float:
    """Roofline model on one H100 SXM: max(FLOPs / peak, bytes / HBM rate)
    of the eval forward (``models.cnn.forward_cost``); INT8 at twice the
    bf16 peak, less half the weight bytes (the reference's formula)."""
    cost = cnn.forward_cost(cfg, variables, batch, image_size)
    chip = H100_SXM
    peak = chip.peak_int8 if int8 else chip.peak_bf16
    byts = cost["bytes"]
    if int8:
        byts -= 0.5 * pr.param_bytes(variables["params"])   # int8 weights
    return max(cost["flops"] / peak, byts / chip.hbm_bw) * 1000


# ------------------------------------------------------------------ methods
@dataclasses.dataclass
class MethodResult:
    method: str
    accuracy: float
    drop: float
    size_bytes: int
    size_reduction: float
    theta: float
    measured_ms: float
    modeled_ms: float
    compliant: bool


@contextlib.contextmanager
def _stage(seconds: Dict[str, float], name: str, device) -> Iterator[None]:
    """Adds the stage's seconds, its device work included, to
    ``seconds[name]``."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


def run_experiment(arch: str, delta_ax: float = 0.015, train_steps: int = 400,
                   n_train: int = 6000, n_val: int = 2000, n_calib: int = 1000,
                   width: float = 0.5, log=print, device=None,
                   act_method: str = "kl") -> Dict:
    """The reference's table for ``arch`` (four rows: Baseline, Q8-only,
    P50-only, HQP), with what the port adds: each row's eager latency
    (``measured_eager_ms``), the seconds of each stage and the device.
    ``act_method`` (absmax | percentile | kl, the reference's kl by
    default) calibrates the activations of the Q8 and HQP rows."""
    device = resolve_device(device)
    hqp = dataclasses.replace(ALGORITHM1, delta_ax=delta_ax,
                              act_method=act_method)
    cfg = dataclasses.replace(get_cnn_config(arch), width_mult=width)
    train_data = SyntheticImages(n_train, seed=0)
    val_data = SyntheticImages(n_val, seed=100)
    calib_data = SyntheticImages(n_calib, seed=200)
    seconds: Dict[str, float] = {}
    eager: Dict[str, float] = {}

    def latency(method, variables):
        with _stage(seconds, "latency", device):
            lat = measured_latency_ms(cfg, variables)
        eager[method] = lat["eager_ms"]
        return lat["ms"]

    log(f"[repro:{arch}] training baseline...")
    with _stage(seconds, "train", device):
        variables = train_cnn(cfg, train_data, steps=train_steps, log=log,
                              device=device)
    eval_fn = make_eval_fn(cfg, val_data, device=device)
    with _stage(seconds, "eval", device):
        a_base = eval_fn(variables)
    base_bytes = pr.param_bytes(variables["params"])
    methods = ("Baseline (FP32)", "Quantization Only (Q8)",
               "Pruning Only (P50)", "Proposed HQP")
    base_measured = latency(methods[0], variables)
    base_modeled = modeled_latency_ms(cfg, variables, int8=False)
    log(f"[repro:{arch}] baseline acc={a_base:.4f} size={base_bytes/1e6:.2f}MB"
        f" measured={base_measured:.3f}ms modeled={base_modeled*1000:.1f}us")

    specs = sens.cnn_prune_groups(cfg, variables)
    results: List[MethodResult] = []

    def add(method, acc, size_bytes, theta, meas, model):
        drop = a_base - acc
        results.append(MethodResult(
            method, acc, drop, int(size_bytes),
            1 - size_bytes / base_bytes, theta, meas, model,
            compliant=drop <= delta_ax))

    add(methods[0], a_base, base_bytes, 0.0, base_measured, base_modeled)

    # ---------------- Q8-only (per-tensor PTQ, KL activations) ----------
    log(f"[repro:{arch}] Q8-only...")
    # without sq_grads and eval_fn, compress reads only hqp's PTQ settings
    art_q8 = compress(variables, cfg, hqp=hqp, log=log)
    qv = art_q8.params
    with _stage(seconds, "calibration", device):
        actq = calibrate_activations(cfg, qv, calib_data, hqp.act_method)
    with _stage(seconds, "eval", device):
        acc_q8 = make_eval_fn(cfg, val_data, actq=actq, device=device)(qv)
    eager[methods[1]] = eager[methods[0]]
    add(methods[1], acc_q8, art_q8.manifest.bytes_after, 0.0, base_measured,
        modeled_latency_ms(cfg, variables, int8=True))

    # ---------------- P50-only (magnitude, no constraint) ---------------
    log(f"[repro:{arch}] P50-only (L1 magnitude)...")
    mag = {"params": tree.map_(lambda w: w.float().square(),
                               variables["params"]),
           "stats": tree.map_(torch.zeros_like, variables["stats"])}
    ranked_mag = pr.rank_units(specs, mag)
    n50 = ranked_mag.total // 2
    p50 = pr.apply_prune_masks(variables, ranked_mag, n50)
    with _stage(seconds, "eval", device):
        acc_p50 = eval_fn(p50)
    p50c = pr.compact_params(variables, ranked_mag, n50)
    add(methods[2], acc_p50, pr.param_bytes(p50c["params"]), 0.5,
        latency(methods[2], p50c), modeled_latency_ms(cfg, p50c, int8=False))

    # ---------------- HQP (Algorithm 1 -> robust PTQ) -------------------
    log(f"[repro:{arch}] HQP conditional prune (Fisher S, Δ_ax={delta_ax})...")
    with _stage(seconds, "fisher", device):
        sq = fisher_for(cfg, variables, calib_data)
    with _stage(seconds, "hqp_compress", device):
        art = compress(variables, cfg, sq_grads=sq, eval_fn=eval_fn,
                       hqp=hqp, specs=specs, a_baseline=a_base, log=log)
    seconds["algorithm1_evals"] = sum(h["seconds"]
                                      for h in art.manifest.history)
    log(art.manifest.summary())
    hqp_compact = art.params                 # compacted + fake-quantized
    with _stage(seconds, "calibration", device):
        actq_hqp = calibrate_activations(cfg, hqp_compact, calib_data,
                                         hqp.act_method)
    with _stage(seconds, "eval", device):
        acc_hqp = make_eval_fn(cfg, val_data, actq=actq_hqp,
                               device=device)(hqp_compact)
    add(methods[3], acc_hqp, art.manifest.bytes_after, art.manifest.theta,
        latency(methods[3], hqp_compact),
        modeled_latency_ms(cfg, hqp_compact, int8=True))

    return {
        "arch": arch,
        "baseline_accuracy": a_base,
        "delta_ax": delta_ax,
        "rows": [dataclasses.asdict(r) for r in results],
        "speedups_modeled": {
            r.method: results[0].modeled_ms / r.modeled_ms for r in results},
        "speedups_measured": {
            r.method: results[0].measured_ms / r.measured_ms for r in results},
        "hqp_sparsity_by_family": art.manifest.theta_by_family,
        "hqp_history": art.manifest.history,
        "measured_eager_ms": eager,
        "seconds": seconds,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mobilenetv3s",
                    choices=["mobilenetv3s", "resnet18", "both"])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--width", type=float, default=0.5)
    ap.add_argument("--ntrain", type=int, default=6000)
    ap.add_argument("--nval", type=int, default=2000)
    ap.add_argument("--out", default="experiments/repro")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--act-method", default="kl",
                    choices=["absmax", "percentile", "kl"],
                    help="activation calibration of the Q8 and HQP rows")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = ["mobilenetv3s", "resnet18"] if args.arch == "both" else [args.arch]
    for arch in archs:
        table = run_experiment(arch, train_steps=args.steps, width=args.width,
                               n_train=args.ntrain, n_val=args.nval,
                               device=args.device, act_method=args.act_method)
        (out / f"{arch}.json").write_text(json.dumps(table, indent=1))
        print(json.dumps({k: v for k, v in table.items()
                          if k not in ("hqp_history",)}, indent=1)[:2000])


if __name__ == "__main__":
    main()
