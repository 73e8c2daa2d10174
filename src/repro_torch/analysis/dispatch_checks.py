"""Dispatch-plane invariant checks (analysis plane 1), the port's
counterpart of the JAX package's ``analysis/hlo_checks.py``.

The JAX package lowers each declared hot path and walks the optimized HLO,
the artifact that runs. The port has no HLO: what runs is the sequence of
ops a dispatch body issues, which the card captures into a CUDA graph. So
each check runs the declared body once under ``roofline.cost``'s recording
dispatch mode (``cost.record(observe=...)``) and reads its op trace. Ops
inside a hand-written kernel's op are not seen, on the CPU (its plain
version, counted at its boundary) as on the card (a launch by pointer), so
the trace is the same on both.

  arena-copy      the counterpart of ``donation``: every leaf of a donated
                  pool is the same storage (``data_ptr``, shape) after the
                  dispatch as before, and no op of the body reads a KV leaf
                  and makes a new tensor of a KV leaf's element count: a
                  slot-sized gather is allowed, an arena-sized copy is not.
                  Matching is by element count, as the JAX package's
                  ``f32_roundtrip_violations`` matches (a reshape keeps it).
  f32-roundtrip   no op of the body reads a KV leaf and yields an f32
                  tensor of a non-f32 KV leaf's element count, and no f32
                  tensor of that count is copied into one: the JAX
                  package's §12 bug class (bf16 storage widened through f32,
                  the whole arena copied per write).
  host-syncs      the body makes exactly ``declared - 1`` host reads (the
                  harvest of the dispatch's result is the one a budget of 1
                  allows): ``_local_scalar_dense`` (``.item()``, ``int()``,
                  ``bool()``), ``nonzero``, ``masked_select``, a copy from
                  the card to the host, ``.tolist()``, ``.numpy()``,
                  ``torch.cuda.synchronize`` and the stream and event
                  ``synchronize``. Counted on the CPU too: a read that is
                  harmless there breaks a capture on the card.
  retrace-budget  after a scripted workload, each kind's distinct dispatch
                  keys are at most its declared ``max_lowerings``.

On the card each graph kind's body runs through the engine's
``GraphCache``: eagerly at the key's first use, captured at its second,
both traced. The captured graph (kept with ``GraphCache.debug``) is dumped
(``CUDAGraph.debug_dump``), and no memcpy or memset node in it may move a
KV leaf's bytes: the arena check on the graph itself.

Scenarios cover the KV matrix the engine serves, {bf16, INT8 KV} x
{contiguous, paged}, plus the speculative dual-pool path; the retrace
workload runs on bf16 KV, contiguous and paged, as the JAX package's.
"""
from __future__ import annotations

import contextlib
import os
import re
import tempfile
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.analysis.invariants import REGISTRY, InvariantSpec
from repro_torch.analysis.report import Violation
from repro_torch.compress.artifact import compress
from repro_torch.models import lm
from repro_torch.roofline import cost
from repro_torch.serving import Engine, Request
from repro_torch.serving import state_pool as sp
from repro_torch.serving.speculative import park_position

aten = torch.ops.aten

# ops that read a device value on the host; a copy to the host is found by
# its devices
HOST_READ_OPS = {aten._local_scalar_dense.default: "_local_scalar_dense",
                 aten.nonzero.default: "nonzero",
                 aten.masked_select.default: "masked_select"}
_COPIES = (aten._to_copy.default, aten.copy_.default)


def _tensors(xs) -> Iterator[torch.Tensor]:
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)
        elif isinstance(x, dict):
            yield from _tensors(list(x.values()))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _aliases(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)


def kv_leaves(pool: Optional[dict]) -> List[torch.Tensor]:
    """Every KV-cache leaf of a pool (recurrent state is not KV)."""
    if pool is None:
        return []
    return [leaf for entry in sp.kv_entries(pool) for leaf in entry.values()]


def pool_leaves(pool: Optional[dict]) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of every tensor of a pool: caches, positions."""
    if pool is None:
        return []
    out = [("pos", pool["pos"])]
    for i, entry in enumerate(pool["caches"]):
        out += [(f"caches[{i}].{k}", leaf) for k, leaf in entry.items()]
    return out


class Trace:
    """What one traced body did: messages per rule."""

    def __init__(self, protected: Sequence[torch.Tensor]):
        self.kv_ptrs = {_storage(t) for t in protected if t.numel()}
        self.counts = {t.numel() for t in protected if t.numel()}
        # f32 leaves (INT8 KV's scales) update in f32 legitimately
        self.narrow_counts = {t.numel() for t in protected
                              if t.numel() and t.dtype != torch.float32}
        self.found: Dict[str, List[str]] = {
            "arena-copy": [], "f32-roundtrip": [], "host-syncs": []}
        self.n_ops = 0

    def host_read(self, what: str) -> None:
        self.found["host-syncs"].append(what)

    def _reads_kv(self, ins: List[torch.Tensor]) -> bool:
        return any(t.numel() and _storage(t) in self.kv_ptrs for t in ins)

    def observe(self, func, args, kwargs, out) -> None:
        self.n_ops += 1
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else (out,)))
        name = func.overloadpacket.__name__
        if func in HOST_READ_OPS:
            self.host_read(HOST_READ_OPS[func])
        elif func in _COPIES:
            src = ins[0] if func is aten._to_copy.default else ins[1]
            dst = outs[0] if func is aten._to_copy.default else ins[0]
            if src.device.type != "cpu" and dst.device.type == "cpu":
                self.host_read(f"{name} from {src.device} to the host")
        if func is aten.copy_.default:
            dst, src = ins[0], ins[1]
            if (dst.numel() and _storage(dst) in self.kv_ptrs
                    and src.dtype == torch.float32
                    and src.numel() in self.narrow_counts):
                self.found["f32-roundtrip"].append(
                    f"copy_ of an f32{list(src.shape)} tensor into a KV "
                    f"leaf: the cache is written through f32")
        if func.is_view or _aliases(func) or not self._reads_kv(ins):
            return
        for o in outs:
            n = o.numel()
            if n in self.counts:
                self.found["arena-copy"].append(
                    f"{name} made a new {o.dtype}{list(o.shape)} tensor "
                    f"from the pool, the size of a KV leaf ({n} elements): "
                    f"an arena copy, where the pool must be updated in "
                    f"place")
            if o.dtype == torch.float32 and n in self.narrow_counts:
                self.found["f32-roundtrip"].append(
                    f"{name} widened a KV leaf to f32{list(o.shape)}: "
                    f"the KV storage round-trips through f32 (store it in "
                    f"its own dtype, kernels.kv_layout)")


_HOOKED = ((torch.Tensor, "tolist"), (torch.Tensor, "numpy"),
           (torch.cuda, "synchronize"), (torch.cuda.Stream, "synchronize"),
           (torch.cuda.Event, "synchronize"))


@contextlib.contextmanager
def _host_read_hooks(trace: Trace) -> Iterator[None]:
    """Count the host reads no dispatch mode sees (``tolist``, ``numpy``,
    the synchronizes) while the recorder counts, outside kernel ops."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in _HOOKED]

    def hook(name, fn):
        def read(*args, **kwargs):
            if cost.recording():
                trace.host_read(name)
            return fn(*args, **kwargs)
        return read
    try:
        for owner, attr, fn in saved:
            setattr(owner, attr, hook(
                f"{getattr(owner, '__name__', owner)}.{attr}", fn))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def traced(body: Callable[[], None], trace: Trace) -> Callable[[], None]:
    """``body`` run under the recording dispatch mode into ``trace``."""
    def run() -> None:
        with _host_read_hooks(trace), cost.record(observe=trace.observe):
            body()
    return run


def _storages(pools: Sequence[Optional[dict]]) -> List[tuple]:
    return [(path, leaf.data_ptr(), tuple(leaf.shape))
            for pool in pools for path, leaf in pool_leaves(pool)]


def violations(trace: Trace, spec: InvariantSpec, where: str,
               before: List[tuple], after: List[tuple]) -> List[Violation]:
    """The violations of one traced run against its declared spec."""
    out: List[Violation] = []
    if spec.donated:
        moved = [f"{a[0]} {a[2]} at {a[1]:#x} -> {b[2]} at {b[1]:#x}"
                 for a, b in zip(before, after) if a != b]
        if moved or len(before) != len(after):
            out.append(Violation(
                "dispatch", "arena-copy", where,
                f"pool leaves replaced instead of updated in place: "
                f"{'; '.join(moved) or 'the pool changed its leaves'}"))
        out += [Violation("dispatch", "arena-copy", where, m)
                for m in dict.fromkeys(trace.found["arena-copy"])]
    if spec.forbid_f32_roundtrip_on:
        out += [Violation("dispatch", "f32-roundtrip", where, m)
                for m in dict.fromkeys(trace.found["f32-roundtrip"])]
    if spec.host_syncs is not None:
        hits = trace.found["host-syncs"]
        allowed = spec.host_syncs - 1
        if len(hits) != allowed:
            out.append(Violation(
                "dispatch", "host-syncs", where,
                f"{len(hits)} host read(s) in the dispatch body "
                f"({', '.join(hits) or 'none'}) but the declared budget "
                f"of host_syncs={spec.host_syncs} allows exactly "
                f"{allowed} beyond the harvest of its result"))
    return out


def check_callable(body: Callable[[], None], spec: InvariantSpec, *,
                   where: str, pools: Sequence[Optional[dict]],
                   protected: Sequence[torch.Tensor] = (),
                   runner: Optional[Callable] = None,
                   trace: Optional[Trace] = None) -> List[Violation]:
    """Run ``body`` once, traced (through ``runner(traced_body)`` if given,
    e.g. a graph cache's ``run``), and check it against ``spec``.
    ``pools`` are the donated pools, ``protected`` the KV leaves; the
    trace is left in ``trace`` if given."""
    trace = trace or Trace(protected)
    before = _storages(pools)
    run = traced(body, trace)
    (runner or (lambda f: f()))(run)
    return violations(trace, spec, where, before, _storages(pools))


# --------------------------------------------------------- graph dumps
_NODE = re.compile(r'^"[^"]+"\s*\[[^\n]*label="\{\s*(\w+)', re.M)
# a record's (name | value) pairs, and its {{names} | {values}} rows
_PAIR = re.compile(r"\{\s*(\w+)\s*\|\s*(\d+)\s*\}")
_ROWS = re.compile(r"\{\{([^{}]*)\}\s*\|\s*\{([^{}]*)\}\}")


def _fields(block: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for names, values in _ROWS.findall(block):
        for n, v in zip(names.split("|"), values.split("|")):
            if v.strip().isdigit():
                out[n.strip().lower()] = int(v)
    for n, v in _PAIR.findall(block):
        out[n.lower()] = int(v)
    return out


def graph_copy_nodes(dot: str) -> List[Tuple[str, int]]:
    """(kind, bytes) of every memcpy and memset node of a CUDA graph's DOT
    dump (``CUDAGraph.debug_dump``, which prints each node as a record:
    a memcpy's ``Extent`` gives Width x Height x Depth bytes, a memset's
    width x height x elementSize). Raises when such a node carries no size
    that can be read: the check does not pass blind."""
    starts = list(_NODE.finditer(dot))
    nodes = []
    for i, m in enumerate(starts):
        kind = m.group(1).upper()
        if kind not in ("MEMCPY", "MEMSET"):
            continue
        end = starts[i + 1].start() if i + 1 < len(starts) else len(dot)
        f = _fields(dot[m.start():end])
        if "width" not in f:
            raise RuntimeError(
                f"a {kind} node of the CUDA graph dump carries no size that "
                f"can be read: {dot[m.start():end][:600]!r}")
        n = f["width"] * f.get("height", 1)
        n *= f.get("depth", 1) if kind == "MEMCPY" else f.get(
            "elementsize", 1)
        nodes.append((kind, n))
    return nodes


def dump_graph(graph) -> str:
    """The DOT text of a captured graph (kept by a ``GraphCache`` in debug
    mode)."""
    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        graph.debug_dump(path)
        with open(path) as fh:
            return fh.read()
    finally:
        os.unlink(path)


def graph_violations(nodes: Sequence[Tuple[str, int]], where: str,
                     protected: Sequence[torch.Tensor]) -> List[Violation]:
    """No memcpy or memset node of a captured graph moves a KV leaf's
    bytes."""
    sizes = {t.numel() * t.element_size() for t in protected if t.numel()}
    return [Violation("dispatch", "arena-copy", where,
                      f"the captured graph holds a {kind} node of {n} B, "
                      f"the bytes of a KV leaf: an arena copy on the card")
            for kind, n in nodes if n in sizes]


# ------------------------------------------------------- engine scenarios
def protected_leaves(eng) -> List[torch.Tensor]:
    return kv_leaves(eng.pool) + kv_leaves(eng.draft_pool)


def _pools(eng, spec: InvariantSpec) -> List[dict]:
    """The pools a spec's donated names stand for: ``pool`` and ``vpool``
    the engine's (the verifier's), ``dpool`` the drafter's."""
    named = {"pool": eng.pool, "vpool": eng.pool, "dpool": eng.draft_pool}
    return [named[n] for n in spec.donated]


def _rewind(eng) -> None:
    """Every slot back to position 0, outside any traced body, so each use
    of a representative dispatch starts where the first did."""
    for pool in (eng.pool, eng.draft_pool):
        if pool is not None:
            pool["pos"].zero_()


def engine_hot_paths(eng) -> Dict[str, Tuple[Optional[str], tuple,
                                             Callable[[], None]]]:
    """name -> (graph kind or None, key, body): each declared hot path with
    representative inputs from the engine's own dispatch sites. Graph
    kinds run through the engine's ``GraphCache``; the others (admission's
    reset, copy-on-write) run eagerly, as the engine runs them."""
    sc = eng.scheduler.cfg
    n, chunk_w = eng.n_slots, sc.prefill_chunk
    chunk = eng.inputs.put(("chunk", chunk_w),
                           np.zeros((1, chunk_w), np.int32))
    win_pre = eng._window(chunk_w)
    active = np.ones((n,), bool)
    if eng.paged:
        n_blk = eng._table_width(win_pre)
        row = eng.inputs.put(("row", n_blk), eng.table[:1, :n_blk])
        idx = eng.inputs.put("slot", np.array([0]))
        slot_args, pre_key = (idx, chunk, win_pre, row), (chunk_w, win_pre)
    else:
        slot_args, pre_key = (0, chunk, win_pre), (chunk_w, win_pre, 0)
    paths: Dict[str, tuple] = {
        "engine.reset": (None, None,
                         lambda: sp.reset_slot(eng.pool, 0, 0))}
    if eng.paged:
        paths["engine.copy_page"] = (None, None,
                                     lambda: sp.copy_page(eng.pool, 1, 2))
    if eng.spec is None:
        win_dec = eng._window(chunk_w + sc.decode_steps)
        host = np.zeros((4, n), np.int64)
        host[1], host[2], host[3] = 1, -1, sc.decode_steps
        inputs = eng.inputs.put("decode", host)
        table = eng._dispatch_table(win_dec, active) if eng.paged else None
        paths["engine.prefill"] = (
            "prefill", pre_key,
            lambda: eng._prefill_chunk(eng.pool, *slot_args))
        paths["engine.decode"] = (
            "decode", win_dec,
            lambda: eng._decode_steps(eng.pool, inputs, sc.decode_steps,
                                      win_dec, table))
    else:
        k, c = eng.spec.k, eng.spec.cycles
        win_dec = eng._window(chunk_w + c * (k + 1))
        host = np.zeros((5, n), np.int64)
        host[2], host[3], host[4] = 1, -1, c * (k + 1)
        inputs = eng.inputs.put("spec", host)
        table = eng._dispatch_table(win_dec, active) if eng.paged else None
        out = torch.zeros((2 * c * (k + 1) + 2, n), dtype=torch.long,
                          device=eng.device)
        park = park_position(eng.max_seq)
        paths["engine.spec_prefill"] = (
            "spec_prefill", pre_key,
            lambda: eng._spec_prefill_chunk(eng.draft_pool, eng.pool,
                                            *slot_args))
        paths["engine.spec"] = (
            "spec", (win_dec, k, c),
            lambda: eng.spec.dispatch(eng.draft_pool, eng.pool, table,
                                      inputs, out, k, c, win_dec, park))
    return paths


def spec_for(eng, name: str) -> InvariantSpec:
    """The engine's own declaration of a graph kind, else the registry's."""
    kind = name.split(".", 1)[1]
    spec = eng.invariants.get(kind) or REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"{name}: no declared invariants "
                       f"({sorted(REGISTRY)})")
    return spec


def check_engine(eng, scenario: str, log=None) -> List[Violation]:
    """Every declared hot path of ``eng``, traced. A graph kind runs twice
    through the engine's graph cache (on the card: eager, then captured
    and replayed, and the captured graph's dump checked too). ``log``
    gets one line: what was traced."""
    protected = protected_leaves(eng)
    on_card = eng.device.type == "cuda"
    out: List[Violation] = []
    n_runs = n_ops = n_graphs = n_nodes = 0
    if on_card:
        eng.graphs.debug = True
    for name, (kind, key, body) in engine_hot_paths(eng).items():
        spec = spec_for(eng, name)
        where = f"{name}[{scenario}]"
        pools = _pools(eng, spec)
        uses = 1 if kind is None or not on_card else 2
        for _ in range(uses):
            _rewind(eng)
            runner = (None if kind is None else
                      lambda f, kind=kind, key=key: eng.graphs.run(
                          kind, key, f))
            trace = Trace(protected)
            out += check_callable(body, spec, where=where, pools=pools,
                                  protected=protected, runner=runner,
                                  trace=trace)
            n_runs, n_ops = n_runs + 1, n_ops + trace.n_ops
        if kind is not None and on_card:
            graph = eng.graphs.graph(kind, key)
            if graph is None:
                raise RuntimeError(f"{where}: no graph captured at the "
                                   f"key's second use")
            nodes = graph_copy_nodes(dump_graph(graph))
            out += graph_violations(nodes, where, protected)
            n_graphs, n_nodes = n_graphs + 1, n_nodes + len(nodes)
    _rewind(eng)
    if log is not None:
        log(f"[dispatch] scenario {scenario}: {n_runs} traced runs, "
            f"{n_ops} ops seen"
            + (f", {n_graphs} captured graphs dumped, {n_nodes} memcpy/"
               f"memset nodes" if on_card else ""))
    return out


def check_retrace(eng, scenario: str, *,
                  prompt_lens: Sequence[int] = (5, 9, 17, 23, 31),
                  max_new: int = 8, seed: int = 0,
                  log=None) -> List[Violation]:
    """Drive a scripted workload spanning several window buckets, then
    compare each graph kind's distinct keys with its declared
    ``max_lowerings``. ``log`` gets the keys against their bounds."""
    rng = np.random.RandomState(seed)
    vocab = eng.cfg.vocab_size
    reqs = [Request(prompt=rng.randint(0, vocab, n).tolist(),
                    max_new_tokens=max_new) for n in prompt_lens]
    eng.run(reqs, arrival_ticks=list(range(0, 3 * len(reqs), 3)))
    out: List[Violation] = []
    seen = []
    for kind, keys in eng.graphs.keys.items():
        spec = spec_for(eng, f"engine.{kind}")
        if spec.max_lowerings is None:
            continue
        seen.append(f"{kind} {len(keys)} of {spec.max_lowerings}")
        if len(keys) > spec.max_lowerings:
            out.append(Violation(
                "dispatch", "retrace-budget", f"engine.{kind}[{scenario}]",
                f"{len(keys)} distinct dispatch keys after the scripted "
                f"workload, declared max_lowerings={spec.max_lowerings} "
                f"(the window-bucketing bound) — a dynamic value is "
                f"leaking into a graph key"))
    if log is not None:
        log(f"[dispatch] scenario {scenario}: retrace workload of "
            f"{len(reqs)} requests, dispatch keys {', '.join(seen)}")
    return out


# ------------------------------------------------------------- entry points
def build_scenario(quantized_kv: bool, paged: bool, *, speculative=False,
                   arch: str = "qwen3-0.6b", n_slots: int = 2,
                   max_seq: int = 64, page_size: int = 8, device=None):
    """A small live engine for one cell of the KV matrix (the speculative
    cell drafts with the seed-0 parent's PTQ artifact)."""
    dev = resolve_device(device)
    cfg = configs.get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device=dev)
    kw = dict(n_slots=n_slots, max_seq=max_seq, quantized_kv=quantized_kv,
              device=dev)
    if paged:
        kw["page_size"] = page_size
    if speculative:
        art = compress(params, cfg, log=lambda s: None)
        kw.update(draft_params=art.params, draft_manifest=art.manifest)
    return Engine(params, cfg, **kw)


def scenario_name(quantized_kv: bool, paged: bool, speculative=False) -> str:
    return "+".join(["int8" if quantized_kv else "bf16",
                     "paged" if paged else "contig"]
                    + (["spec"] if speculative else []))


def run_dispatch_plane(device=None, log=print) -> List[Violation]:
    """The full dispatch-plane sweep ``scripts/check_static.py`` runs."""
    out: List[Violation] = []
    for quantized_kv in (False, True):
        for paged in (False, True):
            name = scenario_name(quantized_kv, paged)
            eng = build_scenario(quantized_kv, paged, device=device)
            out += check_engine(eng, name, log)
    # speculative dual-pool cell (the spec dispatch + the fused prefill)
    name = scenario_name(True, False, speculative=True)
    eng = build_scenario(True, False, speculative=True, device=device)
    out += check_engine(eng, name, log)
    # retrace budget: one contiguous and one paged workload
    for paged in (False, True):
        name = scenario_name(False, paged)
        eng = build_scenario(False, paged, device=device)
        out += check_retrace(eng, name, log=log)
    return out
