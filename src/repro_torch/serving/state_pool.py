"""Per-slot decode-state pool for the continuous-batching engine, in the
contiguous layout or as a paged KV arena, and the host-side page allocator
and prefix cache of the paged layout.

The contiguous pool is ``lm.init_decode_state(..., per_slot_pos=True)``:
every cache leaf has the slot axis first and ``pos`` is a (n_slots,) int32
tensor. PyTorch updates in place, so a slot's state is a set of views into
the pool: a prefill through those views writes the pool's KV directly, and
no slot is ever copied out or back.

The paged pool (``init_paged_pool``) swaps the per-slot KV for one arena of
(total_pages, page_size) pages shared by every slot; each slot owns a row of
the engine's page table (``PageAllocator`` hands out pages, ``PrefixCache``
shares them between prompts with a common head). A slot's state is then the
whole arena plus its table row as ``pages``. Physical page ``TRASH_PAGE`` is
never handed out: rows that are not live in a dispatch are pointed at it, so
their writes never touch a live page.

A Mamba, mLSTM or sLSTM layer's entry is recurrent state (``is_kv_entry``
is False): the slot's buffers (Mamba's h and conv, the mLSTM's C, n and
m, the sLSTM's h, c, n and m), with the slot axis first in both layouts.
It is not indexed by position, so it is never paged, shared or rolled
back; it is zeroed at admission (``reset_slot``), and a dispatch replaces
it only at its end (``scatter_slot``, ``keep_live``), so a dispatch that
raised part way leaves it as it was. A pattern with no attention layer
(xLSTM) has no KV entry at all: its paged arena is empty."""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.invariants import declare_invariants
from repro_torch.models import lm

TRASH_PAGE = 0


def is_kv_entry(entry: Dict[str, torch.Tensor]) -> bool:
    """True for a position-indexed KV cache entry (pageable); False for a
    recurrent layer's state (slot-resident, O(1) a slot)."""
    return "k" in entry or "k_q" in entry


def kv_entries(pool: Dict[str, Any]) -> List[Dict[str, torch.Tensor]]:
    return [e for e in pool["caches"] if is_kv_entry(e)]


def init_pool(cfg, n_slots: int, max_seq: int, params: Optional[dict] = None,
              quantized_kv: bool = False, device=None) -> Dict[str, Any]:
    """Pool for ``n_slots`` concurrent requests (per-slot ``pos``)."""
    return lm.init_decode_state(cfg, n_slots, max_seq, params=params,
                                per_slot_pos=True, quantized_kv=quantized_kv,
                                device=device)


def init_paged_pool(cfg, n_slots: int, max_seq: int, *, page_size: int,
                    total_pages: int, params: Optional[dict] = None,
                    quantized_kv: bool = False, device=None
                    ) -> Dict[str, Any]:
    """Pool whose KV caches are one shared (total_pages, page_size) arena.
    Page ``TRASH_PAGE`` is reserved, so ``total_pages`` budgets one page
    over the live working set."""
    return lm.init_decode_state(cfg, n_slots, max_seq, params=params,
                                per_slot_pos=True, quantized_kv=quantized_kv,
                                device=device,
                                kv_pages=(total_pages, page_size))


def gather_slot(pool: Dict[str, Any], slot: Union[int, torch.Tensor],
                pos: Optional[int] = None,
                pages: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Slot ``slot`` as a batch=1 ``decode_step`` state. ``pos`` is the
    host's copy of its position, or None for the pool's own, on the device:
    a (1,) view of the pool's positions, or, where ``slot`` is a (1,) int64
    index tensor (a paged engine's slot, read by a CUDA graph that serves
    every slot), gathered through it. Contiguous: views of the pool's
    caches (``slot`` an int). Paged (``pages``, the slot's (1, n_blk) page
    table row): the KV arena whole, and the slot's recurrent state gathered
    through the index."""
    def one(leaf):
        return (leaf.index_select(0, slot) if isinstance(slot, torch.Tensor)
                else leaf[slot:slot + 1])
    if pos is None:
        pos = one(pool["pos"])
    caches = [entry if pages is not None and is_kv_entry(entry)
              else {k: one(leaf) for k, leaf in entry.items()}
              for entry in pool["caches"]]
    state = {"caches": caches, "pos": pos}
    if pages is not None:
        state["pages"] = pages
    return state


def scatter_slot(pool: Dict[str, Any], slot: Union[int, torch.Tensor],
                 state: Dict[str, Any]) -> None:
    """Record a batch=1 state's position (an int, or a (1,) device tensor)
    and its recurrent state in the pool, in place on the device and with no
    host sync (its KV already landed in the pool through the views or the
    page table). ``slot`` as in ``gather_slot``."""
    for entry, new in zip(pool["caches"], state["caches"]):
        if not is_kv_entry(entry):
            for k, leaf in entry.items():
                _put(leaf, slot, new[k])
    _put(pool["pos"], slot, state["pos"])


def _put(leaf: torch.Tensor, slot: Union[int, torch.Tensor],
         value) -> None:
    if isinstance(slot, torch.Tensor):
        leaf.index_copy_(0, slot, value)
    else:
        leaf[slot:slot + 1] = value


# admission and copy-on-write run eagerly between dispatches, on the host's
# integers: no graph, so no bound on keys (analysis.dispatch_checks)
@declare_invariants("engine.reset", host_syncs=1, donated=("pool",),
                    forbid_f32_roundtrip_on=("kv",))
def reset_slot(pool: Dict[str, Any], slot: int, pos0: int = 0) -> None:
    """Admission: the slot's recurrent state is zeroed (it advances
    irreversibly) and its position drops to ``pos0`` (0, or the length of
    a prefix-cache hit, whose pages the slot's table already maps). KV is
    left as it is in both layouts: the previous occupant's entries lie at or
    past ``pos0``, where every later attend masks them until prefill
    overwrites them, and a paged arena holds pages other slots still
    read."""
    for entry in pool["caches"]:
        if not is_kv_entry(entry):
            for leaf in entry.values():
                leaf[slot].zero_()
    set_slot_pos(pool, slot, pos0)


def set_slot_pos(pool: Dict[str, Any], slot: int, pos: int) -> None:
    """The slot's position alone, in place: the fault path gives a
    surviving slot its position back from the host's mirror, and leaves
    its recurrent state, which no dispatch that raised has written."""
    pool["pos"][slot] = pos


def keep_live(caches: List[Dict[str, torch.Tensor]],
              new: List[Dict[str, torch.Tensor]],
              live: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """After one batched step: each recurrent entry of ``new`` where the
    row is ``live`` (B,) bool, else the entry of ``caches`` (the rows that
    are free, mid-prefill or stopped keep their state bit for bit; a KV
    entry, written in place, is ``new``'s). The reference's
    ``select_slots``."""
    out = []
    for old, upd in zip(caches, new):
        if is_kv_entry(upd):
            out.append(upd)
            continue
        out.append({k: torch.where(
            live.reshape((-1,) + (1,) * (v.ndim - 1)), v, old[k])
            for k, v in upd.items()})
    return out


def store_recurrent(pool: Dict[str, Any],
                    caches: List[Dict[str, torch.Tensor]]) -> None:
    """Copy every recurrent entry of ``caches`` into the pool's buffers, in
    place: the end of a dispatch."""
    for entry, new in zip(pool["caches"], caches):
        if not is_kv_entry(entry):
            for k, leaf in entry.items():
                leaf.copy_(new[k])


def rollback_slots(pool: Dict[str, Any], pos: torch.Tensor) -> None:
    """Set every row's position to ``pos`` (B,), in place: a speculative
    verify wrote k+1 candidate positions, and each row keeps the accepted
    ones (a row that emitted nothing goes back where it was). Only ``pos``
    moves. The rejected candidates' K/V stays where it is, masked by the
    absolute causal limit of every later attend until a later write
    replaces it, as after slot reuse."""
    pool["pos"].copy_(pos)


def park_slots(pool: Dict[str, Any], active: torch.Tensor,
               park: int) -> torch.Tensor:
    """Move the rows not ``active`` to position ``park`` for a dispatch that
    writes behind a row's position, in place, and return every row's
    position as it was (``select_slots`` puts it back)."""
    saved = pool["pos"].clone()
    pool["pos"].copy_(torch.where(active, pool["pos"], park))
    return saved


def select_slots(pool: Dict[str, Any], saved: torch.Tensor,
                 active: torch.Tensor) -> None:
    """Keep the pool's positions where ``active``, else restore ``saved``,
    in place: after a speculative dispatch the rows that were not live get
    their positions back. Their K/V needs no restoring: parked
    (``park_slots``), they wrote only on the trash page or past
    ``max_seq``."""
    pool["pos"].copy_(torch.where(active, pool["pos"], saved))


@declare_invariants("engine.copy_page", host_syncs=1, donated=("pool",),
                    forbid_f32_roundtrip_on=("kv",))
def copy_page(pool: Dict[str, Any], src: int, dst: int) -> None:
    """Copy-on-write: arena page ``src`` into page ``dst`` in every KV leaf
    of a paged pool, in place."""
    for entry in kv_entries(pool):
        for leaf in entry.values():
            leaf[dst].copy_(leaf[src])


# --------------------------------------------------------- host-side paging
class PageAllocator:
    """Host-side free-list allocator with refcounts over the KV page arena.

    Physical page 0 is ``TRASH_PAGE`` and never allocated. Sharing is
    refcount-based: a prefix-cache hit bumps the refcount of each shared
    page (``ref``); eviction and copy-on-write drop it (``unref``), and the
    page returns to the free list when the count hits zero. Pure Python —
    allocation happens on the host between dispatches, never inside one."""

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.total_pages = total_pages
        self.refs = np.zeros(total_pages, dtype=np.int32)
        self.refs[TRASH_PAGE] = 1   # permanently pinned
        self._free: List[int] = list(range(total_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.total_pages - 1 - len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        """Allocate ``n`` fresh pages (refcount 1). Raises MemoryError when
        the arena is exhausted — the engine catches this and evicts from the
        prefix cache before retrying."""
        if n > len(self._free):
            raise MemoryError(
                f"KV arena exhausted: want {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.refs[p] = 1
        return out

    def ref(self, pages) -> None:
        for p in pages:
            assert self.refs[p] > 0, f"ref of dead page {p}"
            self.refs[p] += 1

    def unref(self, pages) -> None:
        for p in pages:
            assert p != TRASH_PAGE and self.refs[p] > 0, f"bad unref {p}"
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(int(p))

    def check(self) -> None:
        """Invariant check (tests): every page is either free (ref 0) or
        referenced, never both; the trash page stays pinned."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages on free list"
        assert TRASH_PAGE not in free and self.refs[TRASH_PAGE] == 1
        for p in range(self.total_pages):
            assert (self.refs[p] == 0) == (p in free), \
                f"page {p}: refs={self.refs[p]}, free={p in free}"


class PrefixCache:
    """Hash-keyed shared-prefix page cache (LRU).

    Keys are the raw bytes of page-aligned prompt heads: an entry for
    ``k`` pages maps ``prompt[:k*page_size].tobytes()`` to the k physical
    page ids holding that prefix's KV. Lookup walks candidate lengths
    longest-first and returns the first hit; the hit caps at
    ``align_down(prompt_len - 1, page_size)`` so at least one prompt token
    always goes through prefill (the engine needs its logits for the first
    sampled token). Hit pages are ref'd for the requesting slot — mapping
    is copy-free; the slot only prefills the tail. Prefix KV bits are
    chunking-independent (rope/projection/quantization are all per-token),
    so reuse is bit-exact regardless of how the original prompt was
    chunked."""

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = page_size
        self._entries: "OrderedDict[bytes, List[int]]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: np.ndarray) -> Tuple[int, List[int]]:
        """Longest page-aligned proper-prefix hit: (n_tokens, page ids),
        with every returned page ref'd for the caller. (0, []) on miss."""
        ps = self.page_size
        for k in range((len(prompt) - 1) // ps, 0, -1):
            key = np.ascontiguousarray(prompt[:k * ps]).tobytes()
            pages = self._entries.get(key)
            if pages is not None:
                self._entries.move_to_end(key)
                self.alloc.ref(pages)
                return k * ps, list(pages)
        return 0, []

    def insert(self, prompt: np.ndarray, pages: List[int],
               n_tokens: int) -> int:
        """Register every page-aligned prefix of a freshly prefilled prompt
        (``pages`` = the slot's table row, ``n_tokens`` = prompt length).
        Returns the longest number of tokens now cached — the slot's pages
        up to that point are shared and must be treated copy-on-write."""
        ps = self.page_size
        shared = 0
        for k in range(1, n_tokens // ps + 1):
            key = np.ascontiguousarray(prompt[:k * ps]).tobytes()
            if key in self._entries:
                self._entries.move_to_end(key)
            else:
                entry = list(pages[:k])
                self.alloc.ref(entry)
                self._entries[key] = entry
            shared = k * ps
        return shared

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry, unref'ing its pages. Returns
        False when the cache is empty (arena pressure is then real — the
        engine's alloc retry will raise)."""
        if not self._entries:
            return False
        _, pages = self._entries.popitem(last=False)
        self.alloc.unref(pages)
        return True

    def clear(self) -> None:
        while self.evict_lru():
            pass
