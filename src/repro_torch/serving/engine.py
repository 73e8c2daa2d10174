"""Continuous-batching serving engine over (possibly HQP-quantized) params.

The ``Engine`` owns ``n_slots`` concurrent requests. Requests are admitted
into free slots on arrival, prefilled in chunks interleaved with batched
decode (``serving.scheduler`` owns the policy), and evicted on EOS or
length, freeing the slot for the next waiting request. Greedy decoding, no
speculation. The KV lives in a contiguous per-slot pool or, with
``page_size``, in a paged arena shared by all slots (``state_pool``).

Each decode dispatch runs ``decode_steps`` greedy steps on the device with
no host round trip between them: argmax, token feedback and the per-slot
EOS/length stop flags stay on the device, and one host sync at the end
harvests the emitted tokens (``stats["host_syncs"]`` against
``stats["device_steps"]``).

On the card each decode dispatch and each prefill chunk runs as a CUDA
graph, captured once per key and replayed (``serving.dispatch``): the
counterpart of the reference engine's jitted ``_decode`` scan and
``_prefill``. Decode is keyed by its static window (``decode_steps`` is
fixed per engine); prefill by (chunk width, window), and in the contiguous
layout by the slot too, whose cache is a view at the slot's offset. The
bodies read fixed device buffers (``dispatch.Inputs``: the tokens, live
flags, EOS ids and budgets of a decode dispatch, the chunk, the page
tables), write the pool in place and their results into fixed outputs,
and make no host sync: a graph bakes in every address and host value. On
the CPU they run eagerly.

Token-identity contract: engine outputs equal serial single-request decode
token for token, because (a) every op is row-independent (``layers`` keeps
the norms and bf16 products batch-invariant; the INT8 and attention kernels
are row-independent by design); (b) chunked prefill and decode attend the
cache through the same ops as the serial path, whose causal limits are
absolute positions, so chunk boundaries and window buckets leave every row's
bits unchanged; (c) rows that are not live in a dispatch never advance
``pos``, and whatever they write sits at or past their own position, where
it stays masked until a real write replaces it; in paged mode they are
pointed at the trash page, so their writes never reach a live page.

A fault in a step propagates to the caller: request-scoped fault isolation
comes with the service plane (ROADMAP), and catching every exception here
would hide a kernel that fails.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.kv_layout import page_count
from repro_torch.models import lm
from repro_torch.serving import sampling as smp
from repro_torch.serving import state_pool as sp
from repro_torch.serving.dispatch import GraphCache, Inputs
from repro_torch.serving.scheduler import (DECODE, PREFILL, Scheduler,
                                           SchedulerConfig)

FREE = "free"


@dataclasses.dataclass
class Request:
    """One generation request (token ids in, token ids out; greedy).

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
    finish_reason: str                # "eos" | "length"
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
    result: Optional[RequestResult] = None
    eos_id: Optional[int] = None
    max_new_tokens: int = 0
    pages: List[int] = dataclasses.field(default_factory=list)


def _kv_bytes(pool) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for entry in pool["caches"] for leaf in entry.values())


class Engine:
    """Continuous-batching engine serving a (possibly HQP-quantized) LM.

    ``params`` must lie on ``device`` (default: the card). ``quantized_kv``
    selects the INT8 KV cache (HQP serving).

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

    Shared pages need no copy-on-write here: a hit admits the slot at the
    hit position, capped at ``(len - 1) // page_size`` pages, so every write
    of the slot lands at or past it; insertion covers only pages the prompt
    fills, and decode writes start at the prompt's end. Only a speculative
    healing chunk writes behind that point, so copy-on-write comes with
    speculation (ROADMAP A9)."""

    def __init__(self, params: Any, cfg, n_slots: int = 4,
                 max_seq: int = 128, sched: Optional[SchedulerConfig] = None,
                 quantized_kv: bool = False, device=None,
                 page_size: Optional[int] = None,
                 total_pages: Optional[int] = None,
                 prefix_cache: bool = True):
        self.device = resolve_device(device)
        if lm.params_device(params) != self.device:
            raise ValueError(f"params lie on {lm.params_device(params)}, "
                             f"the engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.scheduler = Scheduler(sched)
        self.paged = page_size is not None
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
            if prefix_cache:
                self.prefix = sp.PrefixCache(self.alloc, page_size)
            # host mirror of every slot's page table; the dispatches read
            # fixed device copies of it (_dispatch_table)
            self.table = np.zeros((n_slots, self.max_pages), np.int32)
            self.pool = sp.init_paged_pool(
                cfg, n_slots, max_seq, page_size=page_size,
                total_pages=total_pages, params=params,
                quantized_kv=quantized_kv, device=self.device)
            kv_bytes = _kv_bytes(self.pool)
            self._kv_page_bytes = kv_bytes // total_pages
            self._kv_token_bytes = self._kv_page_bytes // page_size
        else:
            self.pool = sp.init_pool(cfg, n_slots, max_seq, params=params,
                                     quantized_kv=quantized_kv,
                                     device=self.device)
            kv_bytes = _kv_bytes(self.pool)
        self.slots = [_Slot(i) for i in range(n_slots)]
        self.waiting: List[Request] = []
        self._uid = itertools.count()
        self.ticks = 0
        self.clock = time.monotonic
        self.stats = {"prefill_ticks": 0, "decode_ticks": 0,
                      "decode_slot_steps": 0, "prefill_tokens": 0,
                      "host_syncs": 0, "device_steps": 0,
                      "kv_bytes": kv_bytes, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "bytes_saved": 0,
                      "pages_in_use": 0, "pages_peak": 0,
                      "kv_bytes_peak": 0 if self.paged else kv_bytes}
        # the reference's max_lowerings: one decode executable per window
        # bucket, one prefill executable per (window, chunk width), and here
        # per slot too in the contiguous layout
        sc = self.scheduler.cfg
        n_windows = -(-max_seq // sc.window_block)
        self.graphs = GraphCache(self.device, {
            "decode": n_windows,
            "prefill": n_windows * sc.prefill_chunk
                       * (1 if self.paged else n_slots)}, self.stats)
        self.inputs = Inputs(self.device)
        # the dispatches' outputs, made outside any capture: a decode
        # dispatch's (tokens, emitted) per step and slot, and a chunk's
        # greedy token
        self._decode_out = torch.zeros((2, sc.decode_steps, n_slots),
                                       dtype=torch.long, device=self.device)
        self._chunk_token = torch.zeros((1,), dtype=torch.int32,
                                        device=self.device)

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

    def _release_slot_pages(self, slot: _Slot) -> None:
        """Eviction: drop the slot's page references (pages the prefix cache
        also holds stay resident for later hits) and zero its table row."""
        if slot.pages:
            self.alloc.unref(slot.pages)
            slot.pages = []
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
        self.waiting.append(req)
        return uid

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s.stage != FREE for s in self.slots)

    def _admit(self) -> None:
        for slot in self.slots:
            if not self.waiting:
                return
            if slot.stage != FREE:
                continue
            req = self.waiting.pop(0)
            pos0 = (self._map_slot_pages(slot, req.prompt) if self.paged
                    else 0)
            sp.reset_slot(self.pool, slot.idx, pos0)
            slot.stage = PREFILL
            slot.prompt = req.prompt
            slot.prefill_done = pos0
            slot.eos_id = req.eos_id
            slot.max_new_tokens = req.max_new_tokens
            slot.result = RequestResult(
                uid=req.uid, prompt_len=int(req.prompt.size), tokens=[],
                finish_reason="", t_submit=req._t_submit,
                t_admit=self.clock())

    def _emit(self, slot: _Slot, tok: int,
              finished: List[RequestResult]) -> None:
        res = slot.result
        if not res.tokens:
            res.t_first_token = self.clock()
        res.tokens.append(tok)
        done_eos = slot.eos_id is not None and tok == slot.eos_id
        done_len = len(res.tokens) >= slot.max_new_tokens
        if done_eos or done_len:
            res.finish_reason = "eos" if done_eos else "length"
            res.t_finish = self.clock()
            finished.append(res)
            slot.stage = FREE          # eviction: slot reusable next tick
            slot.result = None
            slot.prompt = None
            if self.paged:
                self._release_slot_pages(slot)
        else:
            slot.last_token = tok
            slot.stage = DECODE

    def _slot_pos(self, slot: _Slot) -> int:
        """Cache position the slot's next decode step writes at: the whole
        prompt plus every emitted token except the newest."""
        return int(slot.prompt.size) + len(slot.result.tokens) - 1

    # ------------------------------------------------------------------ step
    def step(self) -> List[RequestResult]:
        """One engine tick: admit, then run one scheduler action (a decode
        action runs ``decode_steps`` device steps). Returns the requests that
        finished this tick."""
        self._admit()
        prefilling = [s.idx for s in self.slots if s.stage == PREFILL]
        decoding = [s.idx for s in self.slots if s.stage == DECODE]
        action = self.scheduler.next_action(prefilling, decoding)
        finished: List[RequestResult] = []
        if action.kind == PREFILL:
            self._prefill(self.slots[action.slot], finished)
        elif action.kind == DECODE:
            self._decode(action.slots, finished)
        self.ticks += 1
        return finished

    def _prefill(self, slot: _Slot, finished: List[RequestResult]) -> None:
        lo, hi = self.scheduler.chunk_bounds(slot.prompt.size,
                                             slot.prefill_done)
        chunk = self.inputs.put(("chunk", hi - lo), slot.prompt[None, lo:hi])
        window = self._window(hi)
        if self.paged:
            # the slot's table row and index in fixed buffers: one graph
            # serves every slot
            n_blk = self._table_width(window)
            row = self.inputs.put(("row", n_blk),
                                  self.table[slot.idx:slot.idx + 1, :n_blk])
            idx = self.inputs.put("slot", np.array([slot.idx]))
            self.graphs.run("prefill", (hi - lo, window),
                            lambda: self._prefill_chunk(idx, chunk, window,
                                                        row))
        else:
            self.graphs.run("prefill", (hi - lo, window, slot.idx),
                            lambda: self._prefill_chunk(slot.idx, chunk,
                                                        window))
        slot.prefill_done = hi
        self.stats["prefill_ticks"] += 1
        self.stats["prefill_tokens"] += hi - lo
        if hi == slot.prompt.size:
            if self.prefix is not None:
                # the prompt's KV is complete: register its page-aligned
                # heads for later admissions
                self.prefix.insert(slot.prompt, slot.pages, hi)
                self._note_pages()
            tok = int(self._chunk_token.item())
            self.stats["host_syncs"] += 1
            self._emit(slot, tok, finished)

    def _prefill_chunk(self, slot, chunk: torch.Tensor, window: int,
                       pages: Optional[torch.Tensor] = None) -> None:
        """One prefill chunk (1, width) of slot ``slot`` (an int, or a (1,)
        index tensor in paged mode) from the slot's device position, which
        it advances in place; the greedy token of the chunk's last position
        goes to ``_chunk_token``."""
        st = sp.gather_slot(self.pool, slot, pages=pages)
        # route="prefill" for every chunk, the 1-token tail included: the
        # same op serial whole-prompt prefill takes, so the bits agree
        logits, new = lm.decode_step(self.params, self.cfg, st, chunk,
                                     window=window, route="prefill")
        sp.scatter_slot(self.pool, slot, new)
        self._chunk_token.copy_(smp.greedy(logits[0, -1]))

    def _decode(self, slot_ids: Sequence[int],
                finished: List[RequestResult]) -> None:
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
                # deepest write: pos + live steps (a slot that stops early
                # rewrites its stop position, already covered)
                self._ensure_capacity(
                    slot, min(self._slot_pos(slot) + k_steps,
                              int(slot.prompt.size) + slot.max_new_tokens))
        # the deepest live slot after k_steps attends positions
        # <= max(pos) + k_steps - 1  ->  window covers max(pos) + k_steps
        needed = max(self._slot_pos(self.slots[i]) for i in slot_ids) + k_steps
        window = self._window(needed)
        inputs = self.inputs.put("decode", host)
        table = self._dispatch_table(window, active) if self.paged else None
        self.graphs.run("decode", window,
                        lambda: self._decode_steps(inputs, k_steps, window,
                                                   table))
        out = self._decode_out.cpu().numpy()
        toks, emitted = out[0], out[1].astype(bool)
        self.stats["host_syncs"] += 1
        self.stats["device_steps"] += k_steps
        for t in range(k_steps):
            for i in slot_ids:
                if emitted[t, i]:
                    self._emit(self.slots[i], int(toks[t, i]), finished)
        self.stats["decode_ticks"] += 1
        self.stats["decode_slot_steps"] += int(emitted.sum())

    def _decode_steps(self, inputs: torch.Tensor, k_steps: int, window: int,
                      table: Optional[torch.Tensor]) -> None:
        """``k_steps`` greedy steps over every slot, on the device.
        ``inputs`` (4, B): each live slot's last token, live (0/1), EOS id
        (-1 = none), tokens each slot may still emit; ``table`` the
        dispatch's page table (paged mode). Slots that hit EOS or their
        budget freeze for the remaining steps. Writes (toks (K, B), emitted
        (K, B)) into ``_decode_out``."""
        pool = self.pool
        tok, live, eos, left = (inputs[0][:, None], inputs[1] != 0,
                                inputs[2], inputs[3])
        state = pool if table is None else dict(pool, pages=table)
        toks, emitted = [], []
        for _ in range(k_steps):
            logits, new = lm.decode_step(self.params, self.cfg, state, tok,
                                         window=window, route="decode")
            nxt = smp.greedy(logits[:, -1]).long()
            pool["pos"].copy_(torch.where(live, new["pos"], pool["pos"]))
            left = torch.where(live, left - 1, left)
            stop = ((eos >= 0) & (nxt == eos)) | (left <= 0)
            toks.append(torch.where(live, nxt, 0))
            emitted.append(live)
            tok = torch.where(live, nxt, tok[:, 0])[:, None]
            live = live & ~stop
        self._decode_out[0].copy_(torch.stack(toks))
        self._decode_out[1].copy_(torch.stack(emitted))

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
def summarize_results(results: Dict[int, RequestResult],
                      wall_s: float) -> Dict[str, Any]:
    """Throughput and nearest-rank latency/TTFT percentiles over a finished
    result set."""
    if not results:
        return {"n_requests": 0, "out_tokens": 0, "tokens_per_s": 0.0,
                "latency_p50_ms": 0.0, "latency_p95_ms": 0.0,
                "ttft_p50_ms": 0.0, "ttft_p95_ms": 0.0}
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
    }


# ---------------------------------------------------------------- reference
def serial_decode(params, cfg, prompt: Sequence[int], max_new_tokens: int,
                  max_seq: int = 128, eos_id: Optional[int] = None,
                  quantized_kv: bool = False, device=None) -> List[int]:
    """The serial single-request path the engine must match token for
    token: whole-prompt prefill (the prefill route, whatever the prompt's
    length), then one decode step per token, greedy. ``params`` must lie on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    if lm.params_device(params) != dev:
        raise ValueError(f"params lie on {lm.params_device(params)}, "
                         f"serial_decode runs on {dev}")
    prompt = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)
    state = lm.init_decode_state(cfg, 1, max_seq, params=params,
                                 quantized_kv=quantized_kv, device=dev)
    logits, state = lm.decode_step(params, cfg, state, prompt[None],
                                   route="prefill")
    out: List[int] = []
    tok = int(smp.greedy(logits[0, -1]))
    while True:
        out.append(tok)
        if tok == eos_id or len(out) >= max_new_tokens:
            return out
        logits, state = lm.decode_step(
            params, cfg, state,
            torch.full((1, 1), tok, dtype=torch.long, device=dev),
            route="decode")
        tok = int(smp.greedy(logits[0, -1]))
