"""Static analysis over the serving stack, two planes behind one gate
(``python -m repro_torch.scripts.check_static``):

  * the dispatch plane: ``invariants.declare_invariants`` lets a hot path
    of the engine declare what each dispatch must do (a host-sync budget,
    pools updated in place, no f32 widening of KV, a bound on its dispatch
    keys); ``dispatch_checks`` runs each declared body under a recording
    dispatch mode (``roofline.cost``'s) and checks the ops it issued, and
    on the card the CUDA graph it captured. It takes the place of the JAX
    package's HLO walker: the port has no HLO, and its op trace is the
    program that runs.
  * the AST plane: ``astlint`` checks serving-discipline rules the type
    system cannot express (injectable clocks, a single-owner pump, no host
    syncs in a dispatch body, bench-gate messages, deduplicated helpers,
    declared stats keys).
"""
from repro_torch.analysis.invariants import (REGISTRY, InvariantSpec,
                                             declare_invariants, spec_of)
from repro_torch.analysis.report import Violation, render

__all__ = ["REGISTRY", "InvariantSpec", "declare_invariants", "spec_of",
           "Violation", "render"]
