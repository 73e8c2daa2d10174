"""What ROADMAP C14's repair costs a train step on one H100: the
qwen3-0.6b train step of ``chip_smoke.py``'s ``phase_train`` (published
width, batch 64 x 33, AdamW f32 moments) timed with ``layers._exp``'s
overflow guard (the port) and without it (plain ``exp``, whose gradient is
NaN where exp overflows), alternating, in one process.

  python3 scripts/exp_guard_cost.py [--rounds 3] [--steps 10]
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("exp_guard_cost: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    sys.stdout.reconfigure(line_buffering=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build()
    cfg = configs.get_config("qwen3-0.6b")
    ocfg = AdamWConfig(lr=3e-3)
    step = make_train_step(cfg, ocfg)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (64, 33),
                                     generator=gen).to(dev)}
    guarded = L._exp

    def plain(x):
        return torch.exp(x), None

    times = {"guarded": [], "plain": []}
    for r in range(args.rounds):
        order = ("guarded", "plain") if r % 2 == 0 else ("plain", "guarded")
        for name in order:
            L._exp = guarded if name == "guarded" else plain
            params = lm.init_params(cfg, seed=0, device=dev)
            opt = adamw_init(params, ocfg)
            for _ in range(2):                  # first uses
                params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(args.steps):
                params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.monotonic() - t0) / args.steps
            times[name].append(ms)
            print(f"round {r} {name}: {ms:.2f} ms a step over {args.steps} "
                  f"steps (synchronised), loss {float(m['loss']):.4f}  "
                  f"[{card}]")
            del params, opt
            torch.cuda.empty_cache()
    L._exp = guarded
    print(f"median ms a step: guarded {statistics.median(times['guarded']):.2f}"
          f", plain {statistics.median(times['plain']):.2f}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
