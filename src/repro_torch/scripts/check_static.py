"""Static-analysis gate: dispatch-plane invariants + serving-discipline lint.

Runs both analysis planes and exits 1 on any violation, so an invariant
regression fails fast with a named rule instead of showing up as an
unexplained slowdown later.

  plane "dispatch"  builds small live engines across the KV matrix
                    ({bf16, INT8} x {contiguous, paged} + speculative),
                    runs every hot path that carries a
                    ``declare_invariants`` spec under a recording dispatch
                    mode and checks its op trace (on the card, its
                    captured CUDA graph too): no arena copy, no f32
                    widening of KV, the host-sync budget, and the
                    dispatch keys within their bound after a scripted
                    workload.
  plane "ast"       lints ``src/repro_torch/serving/*.py`` and the CI
                    scripts against the rules of
                    ``repro_torch.analysis.astlint``.

Usage:
    PYTHONPATH=src python -m repro_torch.scripts.check_static --device cpu
    PYTHONPATH=src python -m repro_torch.scripts.check_static --plane ast
    PYTHONPATH=src python -m repro_torch.scripts.check_static --plane dispatch

Without ``--device`` the dispatch plane runs on the card (and raises where
there is none); the AST plane needs no device.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis import astlint, render

ROOT = pathlib.Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plane", choices=("dispatch", "ast", "all"),
                    default="all")
    ap.add_argument("--device", default=None,
                    help="device of the dispatch plane's engines (default: "
                         "the card; 'cpu' runs the plain versions)")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)

    violations = []
    if args.plane in ("ast", "all"):
        print(f"[ast] linting {args.root}")
        violations += astlint.lint_tree(args.root)
    if args.plane in ("dispatch", "all"):
        # imported here: the AST plane runs without building an engine
        from repro_torch.analysis import dispatch_checks
        violations += dispatch_checks.run_dispatch_plane(
            device=args.device, log=print)

    print(render(violations))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
