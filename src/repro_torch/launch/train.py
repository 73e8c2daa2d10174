"""LM training launcher: data -> train loop -> checkpoints -> resume (the
JAX package's ``launch/train.py``, on one device: mesh and sharding are not
ported).

Trains ``--arch`` (``--smoke``: its reduced config; dense, MoE, hybrid or
xLSTM, the experts at the capacity factor's drops with the auxiliary
losses; a frontend config, phi-3-vision or musicgen, with zero
embeddings before each row, as the JAX package's launcher) on a synthetic
Markov corpus with AdamW (``--state-dtype int8``:
INT8 moments), ``--microbatches`` of gradient accumulation, a checkpoint
every ``--ckpt-every`` steps into ``--ckpt-dir``, from which a restart
resumes; SIGTERM writes a last checkpoint and exits with 143.

  python -m repro_torch.launch.train --smoke --device cpu --steps 50
  python -m repro_torch.launch.train --steps 200 --ckpt-dir ckpt   # the card
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch import checkpoint as ckpt
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_eval_step, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--state-dtype", default="f32", choices=["f32", "int8"])
    ap.add_argument("--eval-every", type=int, default=50)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    opt_cfg = AdamWConfig(lr=args.lr, state_dtype=args.state_dtype)
    # training: the capacity factor's drops, as the reference's launcher
    step_fn = make_train_step(cfg, opt_cfg, args.microbatches,
                              moe_no_drop=False)
    params = lm.init_params(cfg, seed=0, device=device)
    opt_state = adamw_init(params, opt_cfg)

    data = SyntheticTokens(cfg.vocab_size, args.seq + 1, 4096, seed=0)
    # the reference's val corpus (seed 7) is another chain; this one is seed
    # 0's chain, sampled with seed 7
    val = SyntheticTokens(cfg.vocab_size, args.seq + 1, 512, seed=7,
                          chain_seed=0)
    eval_fn = make_eval_step(cfg)

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), meta = ckpt.restore(args.ckpt_dir,
                                                 (params, opt_state))
        start_step = meta["step"]
        print(f"[train] resumed from step {start_step}")

    stop = {"flag": False}

    def _preempt(signum, frame):
        print("[train] preemption signal — checkpointing and exiting")
        stop["flag"] = True

    previous = signal.signal(signal.SIGTERM, _preempt)
    try:
        # as the reference: a resumed run reshuffles from its start step
        it = data.batches(args.batch, seed=start_step, epochs=10_000)
        t0 = time.time()
        for step in range(start_step, args.steps):
            batch = {"tokens": torch.as_tensor(next(it)["tokens"],
                                               dtype=torch.long,
                                               device=device)}
            if cfg.n_frontend:
                batch["embeds"] = lm.frontend_embeds(cfg, args.batch,
                                                        device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % 10 == 0 or step == args.steps - 1:
                aux = "".join(f" {k}={float(v):.4g}"
                              for k, v in metrics.items() if k != "loss")
                print(f"[train] step {step} "
                      f"loss={float(metrics['loss']):.4f}{aux} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
            if args.eval_every and (step + 1) % args.eval_every == 0:
                vb = next(val.batches(args.batch))
                evb = {"tokens": torch.as_tensor(vb["tokens"],
                                                 dtype=torch.long,
                                                 device=device)}
                if cfg.n_frontend:
                    evb["embeds"] = batch["embeds"]
                acc = float(eval_fn(params, evb))
                print(f"[train] step {step} next-token-acc={acc:.4f}")
            if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                                  or stop["flag"]):
                path = ckpt.save(args.ckpt_dir, step + 1,
                                 (params, opt_state), {"arch": args.arch})
                ckpt.prune_old(args.ckpt_dir)
                print(f"[train] checkpointed -> {path}", flush=True)
            if stop["flag"]:
                sys.exit(143)
    finally:
        signal.signal(signal.SIGTERM, previous)
    print("[train] done")
    return params


if __name__ == "__main__":
    main()
