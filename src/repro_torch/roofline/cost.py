"""The work a step does, counted at the op boundary: the port's counterpart
of the JAX package's ``roofline/hlo_cost.py`` and ``hlo_analysis.py``.

The JAX package parses its compiled HLO; the port has none, so it counts
where its work is defined:

  the hand-written kernels   each public op records the work its shapes
                             define (``boundary``): B1 2·M·K·N INT8, the
                             attention ops their QK and PV products over the
                             window they are handed, and operand + result
                             bytes. Counting inside is suspended, so the
                             plain version's own products are not counted
                             twice, and the card path (which launches by
                             pointer, unseen by any dispatch mode) is counted
                             the same. A differentiable op records its
                             backward too (``differentiable``).
  everything else            a ``TorchDispatchMode``: 2·prod(result)·K for
                             ``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                             ``_int_mm`` (INT8 if an operand is int8; none
                             for K = 1, a multiply), and
                             operand + result bytes for every op that is
                             not a view, as every top-level op of scheduled
                             HLO is a fusion boundary there. An eager op is
                             one launch on the card.
  declared loops             ``loop(n, like)``, the counterpart of
                             ``known_trip_count``: on real tensors every
                             step runs and is counted; on the meta device
                             the body runs three times, the middle one
                             counted n - 2 times, and ``catted`` joins the
                             outputs as n.

So a count reads the same work whatever implements it: CPU, meta and CUDA
tensors of the same shapes give the same ``flops``, ``int8_dot_flops`` and
``bytes``. ``collective_bytes`` is 0: the port runs on one device.
``peak_live_bytes`` follows the outputs the recorder sees (weak
references): the dry run's ``temp_bytes``.

Use::

    with cost.record() as c:
        step(...)
    terms = cost.roofline_terms(c, H100_SXM)
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# products counted by the dispatch mode: the operand whose last dim is the
# contraction
_DOTS = {aten.mm.default: 0, aten.bmm.default: 0, aten._int_mm.default: 0,
         aten.addmm.default: 1, aten.baddbmm.default: 1}
# ops that allocate or alias and move no bytes
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.detach.default,
         aten.lift_fresh.default, aten.alias.default}
_INT8 = (torch.int8, torch.uint8)
# writes into a tensor in place, which move the update, not the tensor:
# read the source (and indices), write its size, as the JAX package counts
# a dynamic-update-slice; the position of the update among the args
_IN_PLACE_WRITES = {aten.copy_.default: 1, aten.index_put_.default: 2,
                    aten._index_put_impl_.default: 2,
                    aten.index_copy_.default: 3, aten.scatter_.src: 3}


@dataclasses.dataclass
class Cost:
    flops: int = 0                  # every product, INT8 ones included
    int8_dot_flops: int = 0
    bytes: int = 0
    collective_bytes: int = 0       # one device: none
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    live_bytes: int = 0
    peak_live_bytes: int = 0

    def add(self, kind: str, flops: int = 0, int8_flops: int = 0,
            nbytes: int = 0, times: int = 1) -> None:
        self.flops += (flops + int8_flops) * times
        self.int8_dot_flops += int8_flops * times
        self.bytes += nbytes * times
        self.ops[kind] = self.ops.get(kind, 0) + times

    def counts(self) -> Dict[str, int]:
        """The three numbers that must not depend on the device."""
        return {"flops": self.flops, "int8_dot_flops": self.int8_dot_flops,
                "bytes": self.bytes}


class _State:
    """The active recorder. A module global, not thread-local: autograd
    runs a CUDA tensor's backward on a thread of its own. ``tagged``
    collects the outputs of a collapsed loop's body, whose autograd nodes
    ``node_times`` then counts as many times as the body (their backward
    runs once there, for all the steps it stands for)."""
    cost: Optional[Cost] = None
    suspended: int = 0
    times: int = 1
    tagged: Optional[list] = None
    node_times: Dict = {}
    observe: Optional[Callable] = None


def _tensors(xs) -> Iterator[torch.Tensor]:
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def nbytes(*xs) -> int:
    """Bytes of every tensor in ``xs`` (nested in lists and tuples; None
    and other values add nothing): numel times element size, so a view or
    a window counts what it shows, not its storage."""
    return sum(t.numel() * t.element_size() for t in _tensors(xs))


def _track(c: Cost, outs) -> None:
    for t in _tensors(outs):
        n = t.numel() * t.element_size()
        if not n:
            continue
        c.live_bytes += n
        c.peak_live_bytes = max(c.peak_live_bytes, c.live_bytes)
        weakref.finalize(t, _release, c, n)


def _release(c: Cost, n: int) -> None:
    c.live_bytes -= n


def _times_now() -> int:
    """How many times what runs now counts: the enclosing collapsed
    loops', or in a backward, its autograd node's."""
    times = _State.times
    if _State.node_times:
        times *= _State.node_times.get(torch._C._current_autograd_node(), 1)
    return times


def _dot_flops(func, args, out) -> int:
    """2·prod(result)·K; 0 for K = 1, an elementwise product that XLA
    rewrites as a multiply, and the JAX package does not count either."""
    contract = args[_DOTS[func]].shape[-1]
    return 2 * out.numel() * contract if contract > 1 else 0


@functools.lru_cache(maxsize=None)
def _aliases(func) -> bool:
    """Whether an op's result is (a view of) an input: an in-place op's
    result allocates nothing."""
    return any(r.alias_info is not None for r in func._schema.returns)


class _Mode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = _State.cost
        if _State.tagged is not None:
            _State.tagged.extend(_tensors((out,)))
        if c is None or _State.suspended:
            return out
        if _State.observe is not None:
            _State.observe(func, args, kwargs or {}, out)
        if func.is_view or func in _FREE or func.namespace != "aten":
            return out
        times = _times_now()
        flops = int8 = 0
        if func in _DOTS:
            f = _dot_flops(func, args, out)
            operands = [t for t in _tensors(args) if t.dim() >= 1]
            if any(t.dtype in _INT8 for t in operands):
                int8 = f
            else:
                flops = f
        if func in _IN_PLACE_WRITES:
            moved = (nbytes(args[1:], kwargs.values() if kwargs else ())
                     + nbytes(args[_IN_PLACE_WRITES[func]]))
        else:
            moved = nbytes(args, kwargs.values() if kwargs else (), out)
        c.add(func.overloadpacket.__name__, flops, int8, moved, times)
        if not _aliases(func):
            _track(c, out if isinstance(out, (list, tuple)) else (out,))
        return out


@contextlib.contextmanager
def record(observe: Optional[Callable] = None) -> Iterator[Cost]:
    """Count the work of the block into the ``Cost`` it yields. Recorders
    do not nest. ``observe(func, args, kwargs, out)``, if given, sees every
    op the dispatch mode sees outside a kernel's op, views and allocations
    included: the op trace ``analysis.dispatch_checks`` checks."""
    if _State.cost is not None:
        raise RuntimeError("cost.record: a recorder is already active")
    c = Cost()
    _State.cost, _State.suspended, _State.times = c, 0, 1
    _State.tagged, _State.node_times = None, {}
    _State.observe = observe
    try:
        with _Mode():
            yield c
    finally:
        _State.cost, _State.node_times, _State.observe = None, {}, None


def recording() -> bool:
    return _State.cost is not None and not _State.suspended


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """The block's ops are not counted (the inside of a counted op)."""
    _State.suspended += 1
    try:
        yield
    finally:
        _State.suspended -= 1


def add(kind: str, flops: int = 0, int8_flops: int = 0,
        nbytes_: int = 0, outs=()) -> None:
    """Record one op of ``kind`` by hand (times the enclosing loops)."""
    c = _State.cost
    if c is None or _State.suspended:
        return
    c.add(kind, flops, int8_flops, nbytes_, _times_now())
    _track(c, outs)


def boundary(counter: Callable) -> Callable:
    """Decorator for a hand-written kernel's public op. With a recorder
    active the op runs with counting suspended and records ``counter(out,
    *args, **kwargs)`` -> (flops, int8 flops, bytes) under its name; else
    it runs as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with suspended():
                out = fn(*args, **kwargs)
            flops, int8, n = counter(out, *args, **kwargs)
            add(fn.__name__, flops, int8, n,
                out if isinstance(out, tuple) else (out,))
            return out
        return op
    return deco


class _Counted(torch.autograd.Function):
    """A differentiable op counted at its boundary both ways: the forward
    builds its own graph with counting suspended, the backward records
    ``bwd`` and runs that graph's gradient, suspended too. The gradients
    are those of the op's own autograd, bit for bit."""

    @staticmethod
    def forward(ctx, name, fn, fwd, bwd, *inputs):
        add(name, *fwd)
        with suspended(), torch.enable_grad():
            ctx.inputs = [t.detach().requires_grad_(t.requires_grad)
                          for t in inputs]
            out = fn(*ctx.inputs)
        ctx.out, ctx.name, ctx.bwd = out, name, bwd
        with suspended():
            return out.detach().contiguous()

    @staticmethod
    def backward(ctx, d_out):
        add(ctx.name + "_backward", *ctx.bwd)
        wrt = [t for t in ctx.inputs if t.requires_grad]
        with suspended():
            # one layout whatever computed them: what the ops after read
            # must not depend on the implementation
            grads = iter([g.contiguous() for g in
                          torch.autograd.grad(ctx.out, wrt, d_out)])
        inputs, ctx.out, ctx.inputs = ctx.inputs, None, None
        return (None,) * 4 + tuple(next(grads) if t.requires_grad else None
                                   for t in inputs)


def differentiable(name: str, fn: Callable, inputs: Sequence[torch.Tensor],
                   fwd: Sequence[int], bwd: Sequence[int]):
    """``fn(*inputs)``, counted at its boundary: ``fwd`` and ``bwd`` are
    (flops, int8 flops, bytes) of the forward and of the backward. Without
    a recorder it is ``fn(*inputs)`` itself."""
    if not recording():
        return fn(*inputs)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        with suspended():
            out = fn(*inputs)
        add(name, *fwd, outs=(out,))
        return out
    return _Counted.apply(name, fn, tuple(fwd), tuple(bwd), *inputs)


# ------------------------------------------------------------------ loops
@contextlib.contextmanager
def _collapsed(n: int) -> Iterator[None]:
    """The block stands for n steps of a loop body: what it records counts
    n times, and so does the backward of every autograd node it makes."""
    old_times, old_tagged = _State.times, _State.tagged
    _State.times, _State.tagged = old_times * n, []
    try:
        yield
    finally:
        for t in _State.tagged:
            if t.grad_fn is not None:
                _State.node_times.setdefault(t.grad_fn, _State.times)
        _State.times, _State.tagged = old_times, old_tagged


def loop(n: int, like: torch.Tensor) -> Iterator[int]:
    """``range(n)`` for a Python loop whose trip count grows with the
    sequence, the batch, the depth or the experts. On ``like``'s device,
    if it is ``meta`` and only there, the body runs three times: the first
    step, one step that counts n - 2 times (the backward of its autograd
    nodes too), the last step. So a carry's first step, whose state takes
    no gradient, and the gradient a step adds into its neighbour's are
    counted as often as in the loop itself. Join the loop's collected
    outputs with ``catted``."""
    if like.device.type != "meta" or n <= 3 or _State.cost is None:
        yield from range(n)
        return
    yield 0
    with _collapsed(n - 2):
        yield 1
    yield n - 1


def catted(outs: List[torch.Tensor], n: int, dim: int = 0,
           stack: bool = False) -> torch.Tensor:
    """``torch.cat`` (``torch.stack`` with ``stack``) of the n outputs a
    ``loop(n, ...)`` collected. Where its body ran three times (the meta
    device) the middle output stands for the n - 2 middle steps: it joins
    once, then as a broadcast copy without a gradient for the other
    n - 3, so the join reads and writes the bytes of n outputs."""
    if len(outs) >= n:
        if stack:
            return torch.stack(outs, dim)
        return outs[0] if n == 1 else torch.cat(outs, dim)
    if stack:
        outs = [o.unsqueeze(dim) for o in outs]
    mid, k = outs[1].detach(), n - len(outs)
    if mid.shape[dim] == 1:
        mid = mid.expand(*mid.shape[:dim], k, *mid.shape[dim + 1:])
    else:
        with suspended():       # a meta tensor: no bytes move
            mid = mid.unsqueeze(dim).expand(
                *mid.shape[:dim], k, *mid.shape[dim:]).flatten(dim, dim + 1)
    return torch.cat([outs[0], outs[1], mid, *outs[2:]], dim)


def repeats(fn: Callable, key: Callable) -> Callable:
    """``fn`` for the meta device's calls that repeat (the dry run's
    optimizer step over layers of one shape): the first call with a
    ``key(*args)`` runs and records; a later call with that key records
    the same again and returns the first call's result."""
    seen: Dict = {}

    def call(*args):
        k = key(*args)
        c = _State.cost
        if k in seen:
            delta, out = seen[k]
            if c is not None and not _State.suspended:
                c.flops += delta.flops
                c.int8_dot_flops += delta.int8_dot_flops
                c.bytes += delta.bytes
                for kind, n in delta.ops.items():
                    c.ops[kind] = c.ops.get(kind, 0) + n
            return out
        before = dataclasses.replace(c, ops=dict(c.ops)) if c else Cost()
        out = fn(*args)
        after = c or Cost()
        seen[k] = (Cost(
            flops=after.flops - before.flops,
            int8_dot_flops=after.int8_dot_flops - before.int8_dot_flops,
            bytes=after.bytes - before.bytes,
            ops={kind: n - before.ops.get(kind, 0)
                 for kind, n in after.ops.items()
                 if n != before.ops.get(kind, 0)}), out)
        return out
    return call


# ------------------------------------------------------------------ roofline
def roofline_terms(cost: Cost, chip) -> dict:
    """The lower bound of a step on ``chip`` (seconds) and its three terms,
    as the JAX package's ``hlo_analysis.roofline_terms``: INT8 products at
    ``peak_int8``, the other flops at ``peak_bf16``, bytes at ``hbm_bw``,
    collective bytes at ``nvlink_bw``."""
    t_compute = ((cost.flops - cost.int8_dot_flops) / chip.peak_bf16
                 + cost.int8_dot_flops / chip.peak_int8)
    t_memory = cost.bytes / chip.hbm_bw
    t_coll = cost.collective_bytes / chip.nvlink_bw
    terms = {"t_compute": t_compute, "t_memory": t_memory,
             "t_collective": t_coll}
    return {**terms, "dominant": max(terms, key=terms.get),
            "step_time_lower_bound_s": max(terms.values()),
            "flops": cost.flops, "int8_dot_flops": cost.int8_dot_flops,
            "bytes": cost.bytes, "collective_bytes": cost.collective_bytes}
