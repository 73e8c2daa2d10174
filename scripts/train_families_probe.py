"""Family training at other settings on one H100: the port's
``phase_train_families`` runs (``chip_smoke._train_family``) with the
learning gate reported instead of enforced, and no replay.

Each run is at the family's published width, FAMILY_STEPS steps of
FAMILY_BATCH x FAMILY_SEQ tokens with the capacity factor's drops:
  * at each ``--lr`` (by default the train launcher's 3e-3), every family of
    ``chip_smoke.FAMILY_TRAIN``, then phi3.5-moe with f32 moments (whether
    what it does follows the INT8 moments);
  * at its own lr in FAMILY_TRAIN, phi3.5-moe with its load-balance loss's
    weight times each ``--lb-scale`` (whether the drops answer to the aux
    loss).
Prints chip_smoke's ``[train-family]`` lines for each: the losses, the
aux, the drops, the first gradient's norm, clip factor and share under
eps, the first batch's CE before and after, the non-finite param values
after the last step.

  python3 scripts/train_families_probe.py [--lr 3e-3 ...] [--lb-scale 0 10]
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="*", default=[3e-3])
    ap.add_argument("--lb-scale", type=float, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("train_families_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, flash_attention
    sys.stdout.reconfigure(line_buffering=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build()
    kernels = {"flash_attention": flash_attention.KERNEL}
    runs = [(arch, layers, dtype, flash)
            for arch, layers, dtype, flash, _ in cs.FAMILY_TRAIN]
    phi = next(r for r in cs.FAMILY_TRAIN if r[0] == cs.MOE_ARCH)
    runs.append((phi[0], phi[1], "f32", phi[3]))
    for lr in args.lr:
        for arch, layers, dtype, flash in runs:
            cs._train_family(arch, layers, dtype, flash, lr, dev, kernels,
                             card, gate=False, replay=False)
            cs._free()
    from repro_torch import configs
    weight = configs.get_config(cs.MOE_ARCH).moe.load_balance_loss
    for scale in args.lb_scale:
        cs._train_family(*phi, dev, kernels, card, gate=False, replay=False,
                         moe_weights={"load_balance_loss": scale * weight})
        cs._free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
