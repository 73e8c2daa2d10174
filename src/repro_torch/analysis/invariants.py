"""Declared invariants of the serving engine's hot paths.

The serving stack's hardest-won properties (one host sync per decode
dispatch, pools updated in place, KV never widened to f32, a bounded number
of dispatch keys under window bucketing) are invisible to token-level tests.
``declare_invariants`` lets the code that builds a hot path say, next to
it, what every dispatch of it must look like; ``analysis.dispatch_checks``
later runs the declared body under a recording dispatch mode and checks
each claim against the ops it issued (and, on the card, against the CUDA
graph it captured).

Usage (``serving/engine.py``)::

    declare_invariants(
        "engine.decode", host_syncs=1, donated=("pool",),
        forbid_f32_roundtrip_on=("kv",),
        max_lowerings=self.graphs.bounds["decode"])(self._decode_steps)

Spec fields (all optional):

  host_syncs            host round trips one dispatch may cost. Harvesting
                        the dispatch's result is always one, so the body
                        must make exactly ``host_syncs - 1`` host reads
                        (``.item()``, ``.tolist()``, a copy to the host,
                        ``nonzero``, ``torch.cuda.synchronize``).
  donated               names of the arguments (pools) the body updates in
                        place: every leaf keeps its storage, and no op in
                        the body makes a copy the size of a KV leaf.
  forbid_f32_roundtrip_on  cache families (today: "kv") that no op in the
                        body may widen to an f32 tensor of a leaf's size.
  max_lowerings         most distinct dispatch keys after a scripted
                        workload: the bound of the kind's ``GraphCache``
                        (a captured graph is the port's lowering).

The decorator records the spec in a module registry (name -> spec; specs
only, never the callable, which would keep a whole engine's pools alive)
and, where the callable allows it, sets it on the function as
``__repro_invariants__``. It returns the callable unchanged, so it costs a
dispatch nothing. Registering a name again overwrites it: every Engine
declares its own bounds, and the last-built engine's declaration is the
one a checker run against that engine must see.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InvariantSpec:
    name: str
    host_syncs: Optional[int] = None
    donated: Tuple[str, ...] = ()
    forbid_f32_roundtrip_on: Tuple[str, ...] = ()
    max_lowerings: Optional[int] = None
    arg_names: Tuple[str, ...] = ()


REGISTRY: Dict[str, InvariantSpec] = {}


def declare_invariants(name: str, *, host_syncs: Optional[int] = None,
                       donated: Tuple[str, ...] = (),
                       forbid_f32_roundtrip_on: Tuple[str, ...] = (),
                       max_lowerings: Optional[int] = None):
    """Attach an :class:`InvariantSpec` to a hot path's callable and record
    it under ``name`` in the module registry. Returns the callable
    unchanged: no cost on the hot path."""
    def wrap(fn):
        inner = getattr(fn, "__wrapped__", fn)
        try:
            arg_names = tuple(inspect.signature(inner).parameters)
        except (TypeError, ValueError):
            arg_names = ()
        for n in donated:
            if arg_names and n not in arg_names:
                raise ValueError(
                    f"declare_invariants({name!r}): donated arg {n!r} not "
                    f"in signature {arg_names}")
        spec = InvariantSpec(name=name, host_syncs=host_syncs,
                             donated=tuple(donated),
                             forbid_f32_roundtrip_on=tuple(
                                 forbid_f32_roundtrip_on),
                             max_lowerings=max_lowerings,
                             arg_names=arg_names)
        REGISTRY[name] = spec
        try:
            fn.__repro_invariants__ = spec
        except (AttributeError, TypeError):
            pass    # a bound method or a C callable has no __dict__
        return fn
    return wrap


def spec_of(fn) -> Optional[InvariantSpec]:
    return getattr(fn, "__repro_invariants__", None)
