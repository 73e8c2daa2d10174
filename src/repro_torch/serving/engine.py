"""Continuous-batching serving engine over (possibly HQP-quantized) params.

The ``Engine`` owns ``n_slots`` concurrent requests. Requests are admitted
into free slots on arrival, prefilled in chunks interleaved with batched
decode (``serving.scheduler`` owns the policy), and evicted on EOS or
length, freeing the slot for the next waiting request. Tokens are greedy
or drawn by a seeded ``sampling.SamplingConfig`` (temperature, top-k),
keyed by position so engine and serial decode draw alike. The KV lives in
a contiguous per-slot pool or, with ``page_size``, in a paged arena shared
by all slots (``state_pool``).

Each decode dispatch runs ``decode_steps`` steps on the device with no
host round trip between them: the token pick, token feedback and the
per-slot EOS/length stop flags stay on the device, and one host sync at
the end harvests the emitted tokens (``stats["host_syncs"]`` against
``stats["device_steps"]``). With ``draft_params`` the engine is
speculative (``serving.speculative``): the params are the verifier, the
drafter has a pool of its own, and a decode dispatch runs ``spec_cycles``
draft -> verify cycles instead.

On the card each decode dispatch and each prefill chunk runs as a CUDA
graph, captured once per key and replayed (``serving.dispatch``): the
counterpart of the reference engine's jitted ``_decode`` scan and
``_prefill``. Decode is keyed by its static window (``decode_steps`` is
fixed per engine); prefill by (chunk width, window), and in the contiguous
layout by the slot too, whose cache is a view at the slot's offset. A
speculative engine has the kinds ``spec``, keyed (window, k_eff,
cycles_eff), and ``spec_prefill``, keyed as ``prefill``. The bodies read
fixed device buffers (``dispatch.Inputs``: the tokens, live flags, EOS ids
and budgets of a decode dispatch, the chunk, the page tables), write the
pool in place and their results into fixed outputs, and make no host
sync: a graph bakes in every address and host value. Positions come from
the pool on the device (a sampled prefill tail is keyed by the pool's
position after the chunk); the sampling seed is fixed per engine, and its
key is a buffer made before any capture. On the CPU the bodies run
eagerly.

Token-identity contract: engine outputs equal serial single-request decode
token for token, because (a) every op is row-independent (``layers`` keeps
the norms and bf16 products batch-invariant; the INT8 and attention kernels
are row-independent by design); (b) chunked prefill and decode attend the
cache through the same ops as the serial path, whose causal limits are
absolute positions, so chunk boundaries and window buckets leave every row's
bits unchanged, and the Mamba recurrence steps position by position on every
route (``models.ssm``); (c) rows that are not live in a dispatch never advance
``pos``, and whatever they write sits at or past their own position, where
it stays masked until a real write replaces it; in paged mode they are
pointed at the trash page, so their writes never reach a live page. A
recurrent state has no mask: each decode step keeps a row's new state only
where the row is live (``state_pool.keep_live``), so a slot that is free,
mid-prefill or stopped mid-dispatch keeps its state bit for bit. A
speculative dispatch writes behind a row's position (its healing chunk
at pos-1), so it parks the rows that are not live past ``max_seq`` for
the dispatch (``speculative.park_position``), and a shared page that a
live row's healing chunk writes into is copied first (copy-on-write).

Request-scoped fault isolation (``step``): a fault in a tick that leaves
the CUDA context usable (``absorbable``) fails only the requests the
failing phase was working on, and the engine serves on. The pool is
written in place, never donated, so a dispatch that raised part way may
have written some of it: every slot it touched fails, and every slot that
survives gets its device position back from the host's mirror, in both
pools (a speculative dispatch parks the rows that are not live). A
dispatch writes recurrent state into the pool only at its end, so a
survivor's recurrent state is where its host position says. A CUDA
error (``torch.AcceleratorError``), a kernel that did not build or launch
(``build.KernelError``) and an ``AssertionError`` propagate: a failing
kernel and a broken invariant stay visible.

``cancel`` frees a request wherever it is (queued, mid-prefill, mid-decode),
``last_step`` holds the measurement of the last tick (its wall time split
into ``telemetry.schema.PHASES`` and its token deltas), ``on_token`` streams
each emitted token and ``tracer`` (a ``telemetry.SpanRecorder``) records
spans, all on the injectable ``clock``. On the card a dispatch returns once
its work is enqueued: under CUDA graphs ``prefill_dispatch`` and
``decode_scan`` time the enqueue of a replay (or a key's eager first use,
or its capture), and ``host_sync`` (the harvest of the dispatch's tokens)
carries the device time.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
from repro_torch.analysis.invariants import REGISTRY, declare_invariants
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.kv_layout import page_count
from repro_torch.models import lm
from repro_torch.serving import sampling as smp
from repro_torch.serving import state_pool as sp
from repro_torch.serving.dispatch import GraphCache, Inputs
from repro_torch.serving.scheduler import (DECODE, PREFILL, Scheduler,
                                           SchedulerConfig)
from repro_torch.serving.speculative import (SpecDecoder, park_position,
                                             pool_margin)

FREE = "free"

# what a tick never absorbs, though a RuntimeError: a CUDA error (sticky,
# it poisons the context) and a kernel that did not build or launch
FATAL = (torch.AcceleratorError, KernelError)


def absorbable(exc: BaseException) -> bool:
    """Whether a fault in a tick leaves the engine able to serve on: an
    injected fault, ``MemoryError`` from the page allocator,
    ``torch.OutOfMemoryError`` from the caching allocator, or a
    ``ValueError`` / ``RuntimeError`` raised by host code; never a CUDA
    error, a kernel's failure or an ``AssertionError``."""
    return (isinstance(exc, (MemoryError, ValueError, RuntimeError))
            and not isinstance(exc, FATAL))


@dataclasses.dataclass
class Request:
    """One generation request (token ids in, token ids out).

    ``uid`` is engine-assigned at submit() (the return value)."""
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    uid: Optional[int] = None


@dataclasses.dataclass
class RequestResult:
    uid: int
    prompt_len: int
    tokens: List[int]                 # generated ids (EOS included if hit)
    finish_reason: str                # "eos" | "length" | "error"
    t_submit: float
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0

    @property
    def ttft_s(self) -> float:
        return self.t_first_token - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_finish - self.t_submit


@dataclasses.dataclass
class _Slot:
    idx: int
    stage: str = FREE                 # free | prefill | decode
    prompt: Optional[np.ndarray] = None
    prefill_done: int = 0
    last_token: int = 0
    prev_token: int = 0               # the token at pos-1, which the
                                      # speculative healing chunk re-feeds
    result: Optional[RequestResult] = None
    eos_id: Optional[int] = None
    max_new_tokens: int = 0
    pages: List[int] = dataclasses.field(default_factory=list)
    n_shared: int = 0                 # leading pages the prefix cache or
                                      # other slots also hold: written only
                                      # after copy-on-write


def _kv_bytes(pool) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for entry in sp.kv_entries(pool) for leaf in entry.values())


class Engine:
    """Continuous-batching engine serving a (possibly HQP-quantized) LM.

    ``params`` must lie on ``device`` (default: the card). ``quantized_kv``
    selects the INT8 KV cache (HQP serving). ``sampling`` draws tokens by
    temperature and top-k from a seed on every surface (None: greedy, the
    argmax with no keys).

    ``draft_params`` makes the engine speculative: ``params`` become the
    verifier (the bf16 parent), ``draft_params`` the drafter (its HQP
    artifact), whose pool has INT8 KV unless ``draft_quantized_kv`` is
    False and is sized from its own (possibly pruned) params. Each decode
    dispatch runs ``spec_cycles`` cycles of ``spec_k`` drafts and one
    multi-position verify (``speculative.SpecDecoder``);
    ``draft_manifest``, the artifact's manifest, is checked against the
    verifier's config first. Both pools share one page table and one
    allocator in the paged layout; a contiguous pool keeps
    ``speculative.pool_margin`` positions past ``max_seq`` for parked
    rows.

    ``page_size`` switches on paged KV: the per-slot pool becomes one arena
    of ``total_pages`` pages (default ``1 + n_slots * ceil(max_seq /
    page_size)``, page 0 being the trash page) with a host-side allocator and
    a page-table row per slot. Pages covering the prompt are mapped at
    admission and grown before each decode dispatch; with ``prefix_cache``
    the page-aligned heads of finished prompts are kept under a content
    hash, so a prompt that repeats a head maps those pages without a copy
    and prefills only its tail. ``page_size == max_seq`` is the contiguous
    layout with one page per slot. Outputs are token-identical to the
    contiguous pool at every page size.

    A slot's leading ``n_shared`` pages are shared (a prefix-cache hit, or
    its own prompt's pages once inserted). Plain decode never writes
    there: a hit admits the slot at the hit position, capped at ``(len -
    1) // page_size`` pages, insertion covers only pages the prompt fills,
    and decode writes start at the prompt's end. A speculative healing
    chunk writes at pos-1, which lies in the last shared page when the
    prompt is page-aligned: that page is copied in both arenas first
    (``stats["cow_copies"]``).

    A pattern with recurrent (``mamba``, ``mlstm``, ``slstm``) layers
    keeps no prefix cache (``prefix`` stays None whatever ``prefix_cache``
    says): a hit would admit the slot past the shared head, whose
    recurrent state is not cached, so its recurrent layers would never see
    the head (ROADMAP C8). A pattern with no attention layer (xLSTM) pages
    an empty arena, as the JAX package's engine does: its slots take
    pages and tables, and every layer's state is recurrent.

    A config with a frontend (phi-3-vision, musicgen) is refused with
    ``NotImplementedError``, as by the JAX package's engine: its requests
    would need per-slot embeddings.

    ``clock`` is the monotonic clock behind every timestamp the engine
    takes: request times, ``last_step`` and the tracer's spans. A
    ``serving.Service`` points it at its own clock, so one fake clock
    drives the whole plane in tests."""

    def __init__(self, params: Any, cfg, n_slots: int = 4,
                 max_seq: int = 128, sched: Optional[SchedulerConfig] = None,
                 quantized_kv: bool = False, device=None,
                 page_size: Optional[int] = None,
                 total_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 sampling: Optional[smp.SamplingConfig] = None,
                 draft_params: Any = None, spec_k: int = 4,
                 spec_cycles: int = 1, draft_manifest=None,
                 draft_quantized_kv: bool = True,
                 clock=telemetry.default_clock):
        if cfg.n_frontend:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves token-only archs; a "
                f"frontend config's requests need per-slot embeddings, "
                f"which the JAX package's engine refuses too (serve it "
                f"through the lockstep loop)")
        self.device = resolve_device(device)
        if lm.params_device(params) != self.device:
            raise ValueError(f"params lie on {lm.params_device(params)}, "
                             f"the engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.scheduler = Scheduler(sched)
        self.sampling = sampling or smp.GREEDY
        # the seed's key: a fixed buffer every captured dispatch reads
        self._base = smp.base_key(self.sampling, self.device)
        self.spec: Optional[SpecDecoder] = None
        if draft_params is not None:
            self.spec = SpecDecoder(cfg, draft_params, params, k=spec_k,
                                    cycles=spec_cycles,
                                    sampling=self.sampling,
                                    draft_manifest=draft_manifest)
        self.paged = page_size is not None
        # recurrent layers: state the prefix cache cannot share (C8)
        self.recurrent = lm.is_recurrent(cfg)
        self.attends = "attn" in cfg.pattern
        self.alloc: Optional[sp.PageAllocator] = None
        self.prefix: Optional[sp.PrefixCache] = None
        if self.paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            self.page_size = page_size
            self.max_pages = page_count(max_seq, page_size)
            if total_pages is None:
                total_pages = 1 + n_slots * self.max_pages
            self.total_pages = total_pages
            self.alloc = sp.PageAllocator(total_pages)
            if prefix_cache and not self.recurrent:
                self.prefix = sp.PrefixCache(self.alloc, page_size)
            # host mirror of every slot's page table; the dispatches read
            # fixed device copies of it (_dispatch_table)
            self.table = np.zeros((n_slots, self.max_pages), np.int32)

            def pool(p, qkv):
                return sp.init_paged_pool(
                    cfg, n_slots, max_seq, page_size=page_size,
                    total_pages=total_pages, params=p, quantized_kv=qkv,
                    device=self.device)
        else:
            pool_seq = max_seq + (0 if self.spec is None
                                  else pool_margin(spec_k))

            def pool(p, qkv):
                return sp.init_pool(cfg, n_slots, pool_seq, params=p,
                                    quantized_kv=qkv, device=self.device)
        self.pool = pool(params, quantized_kv)
        self.draft_pool = (None if self.spec is None
                           else pool(draft_params, draft_quantized_kv))
        kv_bytes = _kv_bytes(self.pool) + (
            0 if self.draft_pool is None else _kv_bytes(self.draft_pool))
        if self.paged:
            self._kv_page_bytes = kv_bytes // total_pages
            self._kv_token_bytes = self._kv_page_bytes // page_size
        self.slots = [_Slot(i) for i in range(n_slots)]
        self.waiting: List[Request] = []
        self._uid = itertools.count()
        self.ticks = 0
        self.clock = clock
        # optional telemetry.SpanRecorder: a passive sink fed the engine's
        # timestamps; None costs nothing
        self.tracer: Optional[telemetry.SpanRecorder] = None
        # the last tick's measurement: {"wall_s", "phases",
        # "prefill_tokens", "decode_tokens"}; the service feeds its
        # admission EWMAs and phase histograms from it
        self.last_step: Optional[dict] = None
        self._ph: Dict[str, float] = {}
        self._finished: List[RequestResult] = []
        # optional per-token sink, on_token(uid, token), called for every
        # emitted token before its request's finish bookkeeping
        self.on_token = None
        # the blast radius of whatever raises next: ("admit", request,
        # slot) | ("slots", [idx, ...]) | None, set before each phase that
        # can fail
        self._fault_phase = None
        # drafted_tokens counts the candidates the device made for slots
        # live at dispatch (speculative drafts, or plain decode steps,
        # those burnt by slots that stopped mid-dispatch included);
        # accepted_tokens the drafts that became emitted tokens (a
        # speculative correction or bonus token is emitted, not accepted),
        # so their ratio is the acceptance rate in both modes; spec_cycles
        # counts verify passes
        self.stats = {"prefill_ticks": 0, "decode_ticks": 0,
                      "decode_slot_steps": 0, "prefill_tokens": 0,
                      "host_syncs": 0, "device_steps": 0,
                      "drafted_tokens": 0, "accepted_tokens": 0,
                      "spec_cycles": 0, "cow_copies": 0,
                      "kv_bytes": kv_bytes, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "bytes_saved": 0,
                      "pages_in_use": 0, "pages_peak": 0,
                      "cancelled": 0, "faults": 0,
                      "kv_bytes_peak": 0 if self.paged else kv_bytes}
        # the reference's max_lowerings: one decode executable per window
        # bucket, one prefill executable per (window, chunk width), and here
        # per slot too in the contiguous layout; speculative: one per
        # (window, k_eff, cycles_eff) that plan() can give, and the fused
        # prefill of both pools as prefill
        sc = self.scheduler.cfg
        n_windows = -(-max_seq // sc.window_block)
        n_prefill = (n_windows * sc.prefill_chunk
                     * (1 if self.paged else n_slots))
        self.graphs = GraphCache(self.device, (
            {"decode": n_windows, "prefill": n_prefill} if self.spec is None
            else {"spec": n_windows * self.spec.n_plans(),
                  "spec_prefill": n_prefill}), self.stats)
        # each dispatch kind's invariants (analysis.dispatch_checks holds
        # them): the harvest is its one host sync, the pools are written in
        # place, no KV leaf is widened to f32, and its keys stay within the
        # cache's bound. Declaring runs nothing per dispatch.
        kinds = ((("decode", self._decode_steps, ("pool",)),
                  ("prefill", self._prefill_chunk, ("pool",)))
                 if self.spec is None else
                 (("spec", self.spec.dispatch, ("dpool", "vpool")),
                  ("spec_prefill", self._spec_prefill_chunk,
                   ("dpool", "vpool"))))
        self.invariants = {}
        for kind, body, donated in kinds:
            declare_invariants(
                f"engine.{kind}", host_syncs=1, donated=donated,
                forbid_f32_roundtrip_on=("kv",),
                max_lowerings=self.graphs.bounds[kind])(body)
            self.invariants[kind] = REGISTRY[f"engine.{kind}"]
        self.inputs = Inputs(self.device)
        # the dispatches' outputs, made outside any capture: a decode
        # dispatch's (tokens, emitted) per step and slot, a chunk's token,
        # and a speculative dispatch's results per (k_eff, cycles_eff)
        self._decode_out = torch.zeros((2, sc.decode_steps, n_slots),
                                       dtype=torch.long, device=self.device)
        self._chunk_token = torch.zeros((1,), dtype=torch.int32,
                                        device=self.device)
        self._spec_out: Dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------ paged KV
    def _note_pages(self) -> None:
        n = self.alloc.pages_in_use
        self.stats["pages_in_use"] = n
        if n > self.stats["pages_peak"]:
            self.stats["pages_peak"] = n
            self.stats["kv_bytes_peak"] = n * self._kv_page_bytes

    def _alloc_pages(self, n: int) -> List[int]:
        """Allocate n pages, evicting prefix-cache LRU entries under arena
        pressure; raises MemoryError only once the cache is drained."""
        if n <= 0:
            return []
        while True:
            try:
                return self.alloc.alloc(n)
            except MemoryError:
                if self.prefix is None or not self.prefix.evict_lru():
                    raise

    def _map_slot_pages(self, slot: _Slot, prompt: np.ndarray) -> int:
        """Admission: map the slot's table row for ``prompt``: the longest
        page-aligned prefix-cache hit (no copy, refcounted) plus fresh pages
        for the rest of the prompt. Returns the hit length in tokens, the
        position prefill resumes from."""
        hit, pages = ((0, []) if self.prefix is None
                      else self.prefix.lookup(prompt))
        try:
            pages = pages + self._alloc_pages(
                page_count(prompt.size, self.page_size) - len(pages))
        except MemoryError:
            # lookup() ref'd the hit pages for this slot: drop them
            if pages:
                self.alloc.unref(pages)
            raise
        slot.pages = pages
        slot.n_shared = hit // self.page_size
        self.table[slot.idx] = 0
        self.table[slot.idx, :len(pages)] = pages
        if hit:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += hit
            self.stats["bytes_saved"] += hit * self._kv_token_bytes
        self._note_pages()
        return hit

    def _ensure_capacity(self, slot: _Slot, upto: int) -> None:
        """Grow the slot's table to cover writes at positions < ``upto``
        before the dispatch: a write through an unmapped entry would land
        on the trash page and lose that KV."""
        need = page_count(min(upto, self.max_seq), self.page_size)
        if need > len(slot.pages):
            new = self._alloc_pages(need - len(slot.pages))
            self.table[slot.idx, len(slot.pages):need] = new
            slot.pages.extend(new)
            self._note_pages()

    def _ensure_writable(self, slot: _Slot, pos: int) -> None:
        """Copy-on-write ahead of a dispatch whose first KV write lands at
        ``pos``. A position inside the slot's shared pages can only be the
        speculative healing chunk's pos-1 after a page-aligned prompt whose
        last page went into the prefix cache: if another holder still
        references that page, it is copied in both arenas and the slot's
        table repointed, so the other holders never see the write. Pages
        before it are never written again."""
        if pos < 0 or pos >= slot.n_shared * self.page_size:
            return
        idx = pos // self.page_size
        old = slot.pages[idx]
        if self.alloc.refs[old] > 1:
            new = self._alloc_pages(1)[0]
            for pool in (self.pool, self.draft_pool):
                if pool is not None:
                    sp.copy_page(pool, old, new)
            self.alloc.unref([old])
            slot.pages[idx] = new
            self.table[slot.idx, idx] = new
            self.stats["cow_copies"] += 1
        slot.n_shared = idx
        self._note_pages()

    def _release_slot_pages(self, slot: _Slot) -> None:
        """Eviction: drop the slot's page references (pages the prefix cache
        also holds stay resident for later hits) and zero its table row."""
        if slot.pages:
            self.alloc.unref(slot.pages)
            slot.pages = []
            slot.n_shared = 0
            self.table[slot.idx] = 0
            self._note_pages()

    def _dispatch_table(self, window: int,
                        active: np.ndarray) -> torch.Tensor:
        """The page table of a decode dispatch, cut to the pages that cover
        ``window`` (so the attention ops take it as it is). Every row not
        ``active`` (free slots, slots mid-prefill) points at the trash page,
        because the shared arena cannot be masked per slot and those rows
        write garbage KV at their position every step. One fixed device
        buffer per width, rewritten only when the table or the mask
        changed."""
        n_blk = self._table_width(window)
        tab = np.where(active[:, None], self.table[:, :n_blk],
                       np.int32(sp.TRASH_PAGE))
        return self.inputs.put(("table", n_blk), tab)

    def _table_width(self, window: int) -> int:
        return min(self.max_pages, page_count(window, self.page_size))

    def _window(self, needed: int) -> int:
        """A dispatch's visible KV window, its graph key: ``needed``
        bucketed by the scheduler; ``max_seq`` for a pattern with no
        attention layer, which reads no window (one key a kind and chunk
        width, not one a bucket)."""
        if not self.attends:
            return self.max_seq
        return self.scheduler.visible_window(
            needed, self.max_seq,
            page_multiple=self.page_size if self.paged else 0)

    # ------------------------------------------------------------- lifecycle
    def submit(self, request: Request) -> int:
        prompt = np.asarray(request.prompt, np.int64)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token list")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first token "
                             "falls out of prefill unconditionally)")
        if prompt.size + request.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_seq={self.max_seq}")
        uid = next(self._uid)
        req = dataclasses.replace(request, uid=uid, prompt=prompt)
        req._t_submit = self.clock()       # type: ignore[attr-defined]
        if self.tracer is not None:
            self.tracer.submit(uid, req._t_submit, int(prompt.size))
        self.waiting.append(req)
        return uid

    def cancel(self, uid: int) -> bool:
        """Abort a request wherever it is: a queued one leaves the waiting
        list; a slotted one (mid-prefill included) frees its slot now and,
        paged, its page references (once: a speculative engine's two arenas
        share one table and one allocator). Neither pool needs scrubbing:
        admission resets the slot's position in both. Returns False when
        the uid is unknown or already finished."""
        for i, req in enumerate(self.waiting):
            if req.uid == uid:
                del self.waiting[i]
                self.stats["cancelled"] += 1
                if self.tracer is not None:
                    self.tracer.finish(uid, self.clock(), "cancelled")
                return True
        for slot in self.slots:
            if slot.stage != FREE and slot.result.uid == uid:
                if self.tracer is not None:
                    self.tracer.finish(uid, self.clock(), "cancelled",
                                       n_tokens=len(slot.result.tokens),
                                       pages_held=len(slot.pages))
                self._free_slot(slot)
                self.stats["cancelled"] += 1
                return True
        return False

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s.stage != FREE for s in self.slots)

    @property
    def n_active(self) -> int:
        return sum(s.stage != FREE for s in self.slots)

    def _admit(self) -> None:
        for slot in self.slots:
            if not self.waiting:
                return
            if slot.stage != FREE:
                continue
            req = self.waiting.pop(0)
            self._fault_phase = ("admit", req, slot)
            pos0 = (self._map_slot_pages(slot, req.prompt) if self.paged
                    else 0)
            sp.reset_slot(self.pool, slot.idx, pos0)
            if self.spec is not None:
                sp.reset_slot(self.draft_pool, slot.idx, pos0)
            slot.stage = PREFILL
            slot.prompt = req.prompt
            slot.prefill_done = pos0
            slot.eos_id = req.eos_id
            slot.max_new_tokens = req.max_new_tokens
            t_admit = self.clock()
            slot.result = RequestResult(
                uid=req.uid, prompt_len=int(req.prompt.size), tokens=[],
                finish_reason="", t_submit=req._t_submit, t_admit=t_admit)
            if self.tracer is not None:
                self.tracer.admit(req.uid, t_admit, slot.idx)
            self._fault_phase = None

    def _free_slot(self, slot: _Slot) -> None:
        """The slot is reusable from the next tick on; paged, its page
        references are dropped (pages the prefix cache also holds stay)."""
        slot.stage = FREE
        slot.result = None
        slot.prompt = None
        slot.prev_token = slot.last_token = 0
        if self.paged:
            self._release_slot_pages(slot)

    def _emit(self, slot: _Slot, tok: int,
              finished: List[RequestResult]) -> None:
        res = slot.result
        if not res.tokens:
            res.t_first_token = self.clock()
            if self.tracer is not None:
                self.tracer.first_token(res.uid, res.t_first_token)
        res.tokens.append(tok)
        if self.on_token is not None:
            self.on_token(res.uid, tok)
        done_eos = slot.eos_id is not None and tok == slot.eos_id
        done_len = len(res.tokens) >= slot.max_new_tokens
        if done_eos or done_len:
            res.finish_reason = "eos" if done_eos else "length"
            res.t_finish = self.clock()
            if self.tracer is not None:
                self.tracer.finish(res.uid, res.t_finish, res.finish_reason,
                                   n_tokens=len(res.tokens),
                                   pages_held=len(slot.pages))
            finished.append(res)
            self._free_slot(slot)      # eviction: reusable next tick
        else:
            slot.last_token = tok
            slot.stage = DECODE

    def _slot_pos(self, slot: _Slot) -> int:
        """Cache position the slot's next decode step writes at: the whole
        prompt plus every emitted token except the newest."""
        return int(slot.prompt.size) + len(slot.result.tokens) - 1

    def _host_pos(self, slot: _Slot) -> int:
        """The host's mirror of the slot's device ``pos``."""
        return (slot.prefill_done if slot.stage == PREFILL
                else self._slot_pos(slot))

    # ------------------------------------------------------------------ step
    def step(self) -> List[RequestResult]:
        """One engine tick: admit, then run one scheduler action (a decode
        action runs ``decode_steps`` device steps). Returns the requests that
        finished this tick.

        A fault in the tick that ``absorbable`` accepts fails the requests
        the failing phase was working on (an admission's request; the
        prefill slot; every slot of a decode dispatch, or the one slot
        whose pages were being grown or copied): they finish with
        ``finish_reason="error"``, their slots and pages are freed,
        ``stats["faults"]`` counts them, and the engine serves on. Any
        other fault, and one with no request to blame, propagates.

        The tick's measurement is left in ``last_step``: wall time, the
        per-phase split (admit / prefill dispatch / decode scan / host
        sync / token fanout, and the total) and the prefill and decode
        token deltas."""
        self._fault_phase = None
        self._ph = {}
        self._finished = []
        p0 = self.stats["prefill_tokens"]
        a0 = self.stats["accepted_tokens"]
        t0 = self.clock()
        try:
            self._step_inner()
        except Exception as exc:
            if not absorbable(exc) or self._fault_phase is None:
                raise
            self._absorb_fault()
        wall = self.clock() - t0
        self._ph["total"] = wall
        self.last_step = {
            "wall_s": wall,
            "phases": self._ph,
            "prefill_tokens": self.stats["prefill_tokens"] - p0,
            "decode_tokens": self.stats["accepted_tokens"] - a0,
        }
        if self.tracer is not None:
            self.tracer.span("step", None, t0, t0 + wall,
                             **{k: round(v, 9) for k, v in self._ph.items()})
        return self._finished

    def _step_inner(self) -> None:
        clk, ph = self.clock, self._ph
        t_in = clk()
        self._admit()
        ph["admit"] = clk() - t_in
        prefilling = [s.idx for s in self.slots if s.stage == PREFILL]
        decoding = [s.idx for s in self.slots if s.stage == DECODE]
        action = self.scheduler.next_action(prefilling, decoding)
        if action.kind == PREFILL:
            self._prefill(self.slots[action.slot], self._finished)
        elif action.kind == DECODE:
            self._decode(action.slots, self._finished)
        self.ticks += 1

    def _prefill(self, slot: _Slot, finished: List[RequestResult]) -> None:
        clk, ph = self.clock, self._ph
        uid = slot.result.uid
        self._fault_phase = ("slots", [slot.idx])
        lo, hi = self.scheduler.chunk_bounds(slot.prompt.size,
                                             slot.prefill_done)
        t_d0 = clk()
        chunk = self.inputs.put(("chunk", hi - lo), slot.prompt[None, lo:hi])
        window = self._window(hi)
        if self.spec is None:
            kind = "prefill"
            body = functools.partial(self._prefill_chunk, self.pool)
        else:
            kind = "spec_prefill"
            body = functools.partial(self._spec_prefill_chunk,
                                     self.draft_pool, self.pool)
        if self.paged:
            # the slot's table row and index in fixed buffers: one graph
            # serves every slot
            n_blk = self._table_width(window)
            row = self.inputs.put(("row", n_blk),
                                  self.table[slot.idx:slot.idx + 1, :n_blk])
            idx = self.inputs.put("slot", np.array([slot.idx]))
            self.graphs.run(kind, (hi - lo, window),
                            lambda: body(idx, chunk, window, row))
        else:
            self.graphs.run(kind, (hi - lo, window, slot.idx),
                            lambda: body(slot.idx, chunk, window))
        t_d1 = clk()
        ph["prefill_dispatch"] = t_d1 - t_d0
        slot.prefill_done = hi
        self.stats["prefill_ticks"] += 1
        self.stats["prefill_tokens"] += hi - lo
        if hi < slot.prompt.size:
            if self.tracer is not None:
                self.tracer.span("prefill", uid, t_d0, clk(), lo=lo, hi=hi,
                                 tokens=0)
            return
        if self.prefix is not None:
            # the prompt's KV is complete: register its page-aligned heads
            # for later admissions; the slot's pages up to there are shared
            # from now on
            ins = self.prefix.insert(slot.prompt, slot.pages, hi)
            slot.n_shared = max(slot.n_shared, ins // self.page_size)
            self._note_pages()
        tok = int(self._chunk_token.item())
        t_s1 = clk()
        ph["host_sync"] = t_s1 - t_d1
        self.stats["host_syncs"] += 1
        # the speculative healing chunk re-feeds [prev, last]: after
        # prefill, pos-1 holds the last prompt token
        slot.prev_token = int(slot.prompt[-1])
        # the span before the emit: a request of one token finishes in it,
        # and its finish must count this chunk's token
        if self.tracer is not None:
            self.tracer.span("prefill", uid, t_d0, t_s1, lo=lo, hi=hi,
                             tokens=1)
        self._emit(slot, tok, finished)
        ph["token_fanout"] = clk() - t_s1

    def _prefill_chunk(self, pool, slot, chunk: torch.Tensor, window: int,
                       pages: Optional[torch.Tensor] = None) -> None:
        """One prefill chunk (1, width) of slot ``slot`` (an int, or a (1,)
        index tensor in paged mode) from the slot's device position, which
        it advances in ``pool`` in place. The token of the chunk's last
        position goes to ``_chunk_token``: greedy, or drawn with the key of
        the position after the chunk, read from the device."""
        logits, new = self._prefill_pool(self.params, pool, slot, chunk,
                                         window, pages)
        self._pick_chunk_token(logits, new)

    def _spec_prefill_chunk(self, dpool, vpool, slot, chunk: torch.Tensor,
                            window: int,
                            pages: Optional[torch.Tensor] = None) -> None:
        """``_prefill_chunk`` of a speculative engine: the chunk goes
        through the drafter's pool ``dpool`` and the verifier's ``vpool``;
        the first token always comes from the verifier."""
        self._prefill_pool(self.spec.draft_params, dpool, slot, chunk,
                           window, pages)
        logits, new = self._prefill_pool(self.params, vpool, slot, chunk,
                                         window, pages)
        self._pick_chunk_token(logits, new)

    def _prefill_pool(self, params, pool, slot, chunk: torch.Tensor,
                      window: int, pages: Optional[torch.Tensor]):
        """The chunk through one model and its pool, whose position and
        recurrent state it records. Returns (logits, new state)."""
        # route="prefill" for every chunk, the 1-token tail included: the
        # same op serial whole-prompt prefill takes, so the bits agree
        st = sp.gather_slot(pool, slot, pages=pages)
        logits, new = lm.decode_step(params, self.cfg, st, chunk,
                                     window=window, route="prefill")
        sp.scatter_slot(pool, slot, new)
        return logits, new

    def _pick_chunk_token(self, logits: torch.Tensor, new) -> None:
        if self.sampling.is_greedy:
            self._chunk_token.copy_(smp.greedy(logits[0, -1]))
        else:
            self._chunk_token.copy_(smp.sample_batch(
                logits[:, -1], self.sampling, self._base, new["pos"]))

    def _decode(self, slot_ids: Sequence[int],
                finished: List[RequestResult]) -> None:
        if self.spec is not None:
            self._spec_decode(slot_ids, finished)
            return
        clk, ph = self.clock, self._ph
        t_d0 = clk()
        k_steps = self.scheduler.cfg.decode_steps
        n = self.n_slots
        # rows: last token, live, EOS id (-1 = none), tokens left
        host = np.zeros((4, n), np.int64)
        host[2] = -1
        host[3] = 1
        active = np.zeros((n,), bool)
        for i in slot_ids:
            slot = self.slots[i]
            host[:, i] = (slot.last_token, 1,
                          -1 if slot.eos_id is None else slot.eos_id,
                          slot.max_new_tokens - len(slot.result.tokens))
            active[i] = True
            if self.paged:
                # growing the slot's pages can exhaust the arena: that
                # fails this slot alone
                self._fault_phase = ("slots", [i])
                # deepest write: pos + live steps (a slot that stops early
                # rewrites its stop position, already covered)
                self._ensure_capacity(
                    slot, min(self._slot_pos(slot) + k_steps,
                              int(slot.prompt.size) + slot.max_new_tokens))
        # from here a fault hits the dispatch: every slot in it fails
        self._fault_phase = ("slots", list(slot_ids))
        # the deepest live slot after k_steps attends positions
        # <= max(pos) + k_steps - 1  ->  window covers max(pos) + k_steps
        needed = max(self._slot_pos(self.slots[i]) for i in slot_ids) + k_steps
        window = self._window(needed)
        inputs = self.inputs.put("decode", host)
        table = self._dispatch_table(window, active) if self.paged else None
        self.graphs.run("decode", window,
                        lambda: self._decode_steps(self.pool, inputs, k_steps,
                                                   window, table))
        t_d1 = clk()
        ph["decode_scan"] = t_d1 - t_d0
        out = self._decode_out.cpu().numpy()
        t_s1 = clk()
        ph["host_sync"] = t_s1 - t_d1
        toks, emitted = out[0], out[1].astype(bool)
        self.stats["host_syncs"] += 1
        self.stats["device_steps"] += k_steps
        self.stats["drafted_tokens"] += k_steps * len(slot_ids)
        self.stats["accepted_tokens"] += int(emitted.sum())
        # spans before the fanout: a finish must count every token its
        # spans carry
        if self.tracer is not None:
            per_slot = emitted.sum(axis=0)
            for i in slot_ids:
                self.tracer.span("decode", self.slots[i].result.uid, t_d0,
                                 t_s1, tokens=int(per_slot[i]),
                                 k_steps=k_steps)
        for t in range(k_steps):
            for i in slot_ids:
                if emitted[t, i]:
                    self._emit(self.slots[i], int(toks[t, i]), finished)
        ph["token_fanout"] = clk() - t_s1
        self.stats["decode_ticks"] += 1
        self.stats["decode_slot_steps"] += int(emitted.sum())

    def _decode_steps(self, pool, inputs: torch.Tensor, k_steps: int,
                      window: int, table: Optional[torch.Tensor]) -> None:
        """``k_steps`` decode steps over every slot, on the device.
        ``inputs`` (4, B): each live slot's last token, live (0/1), EOS id
        (-1 = none), tokens each slot may still emit; ``table`` the
        dispatch's page table (paged mode). Slots that hit EOS or their
        budget freeze for the remaining steps. Writes (toks (K, B), emitted
        (K, B)) into ``_decode_out``, and the rows' recurrent state into
        ``pool`` at the end."""
        tok, live, eos, left = (inputs[0][:, None], inputs[1] != 0,
                                inputs[2], inputs[3])
        extra = {} if table is None else {"pages": table}
        caches = pool["caches"]
        toks, emitted = [], []
        for _ in range(k_steps):
            state = {"caches": caches, "pos": pool["pos"], **extra}
            logits, new = lm.decode_step(self.params, self.cfg, state, tok,
                                         window=window, route="decode")
            caches = sp.keep_live(caches, new["caches"], live)
            if self.sampling.is_greedy:
                nxt = smp.greedy(logits[:, -1]).long()
            else:
                # keyed by the position the token's KV is written at
                nxt = smp.sample_batch(logits[:, -1], self.sampling,
                                       self._base, new["pos"])
            pool["pos"].copy_(torch.where(live, new["pos"], pool["pos"]))
            left = torch.where(live, left - 1, left)
            stop = ((eos >= 0) & (nxt == eos)) | (left <= 0)
            toks.append(torch.where(live, nxt, 0))
            emitted.append(live)
            tok = torch.where(live, nxt, tok[:, 0])[:, None]
            live = live & ~stop
        sp.store_recurrent(pool, caches)
        self._decode_out[0].copy_(torch.stack(toks))
        self._decode_out[1].copy_(torch.stack(emitted))

    def _spec_decode(self, slot_ids: Sequence[int],
                     finished: List[RequestResult]) -> None:
        """``cycles_eff`` speculative cycles of ``k_eff`` drafts over every
        decoding slot, then one host sync. ``SpecDecoder.plan`` keeps the
        deepest write, the last cycle's verify tail, inside ``max_seq``."""
        clk, ph = self.clock, self._ph
        t_d0 = clk()
        n = self.n_slots
        # rows: token at pos-1, pending token, live, EOS id (-1 = none),
        # tokens left
        host = np.zeros((5, n), np.int64)
        host[3] = -1
        host[4] = 1
        active = np.zeros((n,), bool)
        for i in slot_ids:
            slot = self.slots[i]
            host[:, i] = (slot.prev_token, slot.last_token, 1,
                          -1 if slot.eos_id is None else slot.eos_id,
                          slot.max_new_tokens - len(slot.result.tokens))
            active[i] = True
        max_pos = max(self._slot_pos(self.slots[i]) for i in slot_ids)
        k_eff, c_eff = self.spec.plan(max_pos, self.max_seq,
                                      int(host[4][active].max()))
        if self.paged:
            for i in slot_ids:
                slot = self.slots[i]
                # a page copy or growth that fails fails this slot alone
                self._fault_phase = ("slots", [i])
                # the healing chunk writes at pos-1, possibly inside a
                # shared page; the last verify tail is the deepest write
                self._ensure_writable(slot, self._slot_pos(slot) - 1)
                self._ensure_capacity(
                    slot, self._slot_pos(slot) + c_eff * (k_eff + 1))
        self._fault_phase = ("slots", list(slot_ids))
        # the deepest attend: the last cycle's verify chunk tail
        window = self._window(max_pos + c_eff * (k_eff + 1))
        inputs = self.inputs.put("spec", host)
        table = self._dispatch_table(window, active) if self.paged else None
        t = c_eff * (k_eff + 1)
        out = self._spec_out.get((k_eff, c_eff))
        if out is None:
            out = self._spec_out[(k_eff, c_eff)] = torch.zeros(
                (2 * t + 2, n), dtype=torch.long, device=self.device)
        park = park_position(self.max_seq)
        self.graphs.run("spec", (window, k_eff, c_eff),
                        lambda: self.spec.dispatch(
                            self.draft_pool, self.pool, table, inputs, out,
                            k_eff, c_eff, window, park))
        t_d1 = clk()
        ph["decode_scan"] = t_d1 - t_d0
        res = out.cpu().numpy()
        t_s1 = clk()
        ph["host_sync"] = t_s1 - t_d1
        toks, emitted = res[:t], res[t:2 * t].astype(bool)
        self.stats["host_syncs"] += 1
        # k_eff drafter passes (the healing chunk included) and one verify
        # a cycle
        self.stats["device_steps"] += t
        self.stats["spec_cycles"] += c_eff
        self.stats["accepted_tokens"] += int(res[2 * t].sum())
        self.stats["drafted_tokens"] += int(res[2 * t + 1].sum())
        if self.tracer is not None:
            per_slot = emitted.sum(axis=0)
            for i in slot_ids:
                self.tracer.span("spec", self.slots[i].result.uid, t_d0,
                                 t_s1, tokens=int(per_slot[i]),
                                 drafted=int(res[2 * t + 1, i]),
                                 accepted=int(res[2 * t, i]), k=k_eff,
                                 cycles=c_eff)
        # np.nonzero is row-major: each slot's tokens come in order
        for step, i in zip(*np.nonzero(emitted)):
            slot = self.slots[i]
            slot.prev_token = slot.last_token
            self._emit(slot, int(toks[step, i]), finished)
        ph["token_fanout"] = clk() - t_s1
        self.stats["decode_ticks"] += 1
        self.stats["decode_slot_steps"] += int(emitted.sum())

    # ------------------------------------------------------- fault isolation
    def _fail_slot(self, slot: _Slot, now: float) -> None:
        """Evict a faulted slot: its request finishes with
        ``finish_reason="error"``, its slot and pages are freed."""
        res = slot.result
        res.finish_reason = "error"
        if not res.t_first_token:
            res.t_first_token = now
        res.t_finish = now
        if self.tracer is not None:
            self.tracer.finish(res.uid, now, "error",
                               n_tokens=len(res.tokens),
                               pages_held=len(slot.pages))
        self._finished.append(res)
        self._free_slot(slot)
        self.stats["faults"] += 1

    def _absorb_fault(self) -> None:
        """The handler of an absorbed fault (``step``): fail what
        ``_fault_phase`` blames, then give every slot that survives its
        device position from the host's mirror, in both pools. The pool
        is written in place, so a dispatch that raised part way may have
        moved positions (a speculative dispatch parks the rows that are not
        live, and restores them only at its end); the K/V it wrote lies at
        or past each survivor's position, masked until a real write
        replaces it, or on the trash page or past ``max_seq``. Only the
        position is reset: a survivor's recurrent state is written at a
        dispatch's end, so one that raised has not touched it."""
        phase, self._fault_phase = self._fault_phase, None
        now = self.clock()
        if phase[0] == "admit":
            _, req, slot = phase
            if slot.stage != FREE and slot.result.uid == req.uid:
                self._fail_slot(slot, now)
            else:
                # the request left the queue and its slot never went live:
                # pages mapped for it go back
                if self.paged:
                    self._release_slot_pages(slot)
                self.stats["faults"] += 1
                if self.tracer is not None:
                    self.tracer.finish(req.uid, now, "error")
                self._finished.append(RequestResult(
                    uid=req.uid, prompt_len=int(req.prompt.size), tokens=[],
                    finish_reason="error", t_submit=req._t_submit,
                    t_admit=now, t_first_token=now, t_finish=now))
        else:
            for i in phase[1]:
                if self.slots[i].stage != FREE:
                    self._fail_slot(self.slots[i], now)
        for slot in self.slots:
            if slot.stage != FREE:
                for pool in (self.pool, self.draft_pool):
                    if pool is not None:
                        sp.set_slot_pos(pool, slot.idx,
                                        self._host_pos(slot))
        self.ticks += 1

    # ------------------------------------------------------------------- run
    def run(self, requests: Sequence[Request],
            arrivals_s: Optional[Sequence[float]] = None,
            arrival_ticks: Optional[Sequence[int]] = None,
            ) -> Dict[int, RequestResult]:
        """Drive the requests to completion; returns results keyed by the
        request's INDEX in ``requests``.

        ``arrivals_s``: wall-clock offsets (trace replay); ``arrival_ticks``:
        engine-tick offsets (tests). With neither, everything is submitted
        up front."""
        if arrivals_s is not None and arrival_ticks is not None:
            raise ValueError("pass at most one of arrivals_s/arrival_ticks")
        if self.has_work:
            raise RuntimeError("run() requires an idle engine")
        offsets = (arrivals_s if arrivals_s is not None else arrival_ticks
                   if arrival_ticks is not None else [0] * len(requests))
        pending = sorted(zip(offsets, range(len(requests))),
                         key=lambda p: p[0])
        by_wall = arrivals_s is not None
        t0 = self.clock()
        tick0 = self.ticks
        uid_to_index: Dict[int, int] = {}
        results: Dict[int, RequestResult] = {}
        while pending or self.has_work:
            now = (self.clock() - t0) if by_wall else self.ticks - tick0
            while pending and pending[0][0] <= now:
                _, i = pending.pop(0)
                uid_to_index[self.submit(requests[i])] = i
            if self.has_work:
                for res in self.step():
                    results[uid_to_index[res.uid]] = res
            elif pending:
                if by_wall:
                    time.sleep(max(0.0, pending[0][0] - now))
                else:
                    self.ticks += 1     # idle tick until the next arrival
        return results


# ------------------------------------------------------------------- stats
def latency_histogram(values_s: Sequence[float]) -> Dict[str, Any]:
    """Seconds -> the fixed-bucket latency histogram in its JSON form
    (``telemetry.schema.LATENCY_BUCKETS_S``, the JAX package's buckets)."""
    h = telemetry.Histogram("latency_s",
                            buckets=telemetry.schema.LATENCY_BUCKETS_S)
    for v in values_s:
        h.observe(v)
    return h.to_dict()


def summarize_results(results: Dict[int, RequestResult],
                      wall_s: float) -> Dict[str, Any]:
    """Throughput and nearest-rank latency/TTFT percentiles over a finished
    result set, and the latency and TTFT distributions as fixed-bucket
    histograms."""
    if not results:
        return {"n_requests": 0, "out_tokens": 0, "tokens_per_s": 0.0,
                "latency_p50_ms": 0.0, "latency_p95_ms": 0.0,
                "ttft_p50_ms": 0.0, "ttft_p95_ms": 0.0,
                "latency_hist": latency_histogram(()),
                "ttft_hist": latency_histogram(())}
    lat = sorted(r.latency_s for r in results.values())
    ttft = sorted(r.ttft_s for r in results.values())

    def pct(xs, q):
        return xs[max(0, -(-int(q * len(xs)) // 100) - 1)]

    out_tokens = sum(len(r.tokens) for r in results.values())
    return {
        "n_requests": len(results),
        "out_tokens": out_tokens,
        "tokens_per_s": out_tokens / max(wall_s, 1e-9),
        "latency_p50_ms": pct(lat, 50) * 1e3,
        "latency_p95_ms": pct(lat, 95) * 1e3,
        "ttft_p50_ms": pct(ttft, 50) * 1e3,
        "ttft_p95_ms": pct(ttft, 95) * 1e3,
        "latency_hist": latency_histogram(lat),
        "ttft_hist": latency_histogram(ttft),
    }


# ---------------------------------------------------------------- reference
def serial_decode(params, cfg, prompt: Sequence[int], max_new_tokens: int,
                  max_seq: int = 128, eos_id: Optional[int] = None,
                  quantized_kv: bool = False, device=None,
                  sampling: Optional[smp.SamplingConfig] = None,
                  route: str = "decode") -> List[int]:
    """The serial single-request path the engine must match token for
    token: whole-prompt prefill (the prefill route, whatever the prompt's
    length), then one step per token on ``route``, greedy or drawn by
    ``sampling`` with the key of the token's position. ``route="prefill"``
    is the speculative engine's oracle on the card, where the verify pass
    takes the prefill route. ``params`` must lie on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    if lm.params_device(params) != dev:
        raise ValueError(f"params lie on {lm.params_device(params)}, "
                         f"serial_decode runs on {dev}")
    scfg = sampling or smp.GREEDY
    base = None if scfg.is_greedy else smp.base_key(scfg, dev)

    def pick(logits, pos: int) -> int:
        if base is None:
            return int(smp.greedy(logits[0, -1]))
        return int(smp.sample(logits[0, -1], scfg,
                              smp.token_key(base, pos)))

    prompt = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)
    state = lm.init_decode_state(cfg, 1, max_seq, params=params,
                                 quantized_kv=quantized_kv, device=dev)
    logits, state = lm.decode_step(params, cfg, state, prompt[None],
                                   route="prefill")
    out: List[int] = []
    tok = pick(logits, int(prompt.numel()))
    while True:
        out.append(tok)
        if tok == eos_id or len(out) >= max_new_tokens:
            return out
        logits, state = lm.decode_step(
            params, cfg, state,
            torch.full((1, 1), tok, dtype=torch.long, device=dev),
            route=route)
        tok = pick(logits, int(prompt.numel()) + len(out))
