"""Index math of the paged KV layout.

A paged arena drops the slot axis: its leaves are (n_pages, page_size, Hkv,
hd) (scales (n_pages, page_size, Hkv)), and each slot carries a page-table
row of physical page ids, so logical position ``p`` of a slot lives at
``arena[table[p // page_size], p % page_size]``. Physical page 0 is the
trash page: unmapped table entries point at it, and it lies past every
row's causal limit. The arena stores bf16 as bf16; only the values are the
contract.

Consumers: ``gather_pages`` (the plain paged attention: gather the visible
window, then the contiguous plain version), ``scatter_pages`` (the KV
write) and the paged CUDA kernels, which look each position up in the table
themselves."""
from __future__ import annotations

from typing import Optional

import torch


def page_count(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` logical positions (host-side)."""
    return -(-tokens // page_size)


def window_pages(pages: torch.Tensor, page_size: int,
                 window: Optional[int]) -> torch.Tensor:
    """The (B, n_blk) prefix of a (B, max_pages) table that covers the
    static visible ``window`` (None = every page): at most the table's
    width, at least one block. The page-rounded window ends past
    ``window``; those tail positions lie past every causal limit and mask
    to exact zeros."""
    n_blk = (pages.shape[1] if window is None
             else min(pages.shape[1], page_count(window, page_size)))
    return pages[:, :max(n_blk, 1)]


def gather_pages(leaf: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """A paged arena's visible window as a contiguous tensor.

    leaf: (n_pages, page_size, ...); pages: (B, n_blk) int physical page ids
    (a ``window_pages`` prefix). Returns (B, n_blk * page_size, ...): what
    the contiguous layout's first n_blk * page_size positions would hold,
    with unmapped entries (the trash page) only past every row's limit."""
    b, n_blk = pages.shape
    g = torch.index_select(leaf, 0, pages.reshape(-1))
    return g.reshape((b, n_blk * leaf.shape[1]) + tuple(leaf.shape[2:]))


def paged_element_index(pages: torch.Tensor, pos: torch.Tensor, sn: int,
                        page_size: int) -> torch.Tensor:
    """Flat physical indices of logical positions pos..pos+sn-1.

    pages: (B, max_pages) int; pos: (B,) int. Returns (B, sn) int64 into an
    arena flattened to (n_pages * page_size, ...). A negative position
    floors into block -1, which is clamped to the row's first table entry
    (the engine points inactive rows at the trash page, so such a write
    lands there)."""
    p = pos.long()[:, None] + torch.arange(sn, device=pos.device)[None, :]
    blk = torch.clamp(torch.div(p, page_size, rounding_mode="floor"), 0,
                      pages.shape[1] - 1)
    phys = torch.gather(pages.long(), 1, blk)
    return phys * page_size + torch.remainder(p, page_size)


def scatter_flat(leaf: torch.Tensor, upd: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Write (B, sn, ...) ``upd`` in place at the (B, sn) flat indices
    ``idx`` (``paged_element_index``) of a paged arena, and return it.
    Distinct slots never map the same writable page, so rows collide only
    on the trash page, where a duplicate-index write is harmless."""
    n_pages, ps = leaf.shape[:2]
    flat = leaf.view((n_pages * ps,) + tuple(leaf.shape[2:]))
    flat[idx.reshape(-1)] = upd.reshape(
        (idx.numel(),) + tuple(upd.shape[2:])).to(leaf.dtype)
    return leaf


def scatter_pages(leaf: torch.Tensor, upd: torch.Tensor, pages: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Write (B, sn, ...) ``upd`` at logical positions pos..pos+sn-1 through
    the page table, in place, and return ``leaf``."""
    idx = paged_element_index(pages, pos, upd.shape[1], leaf.shape[1])
    return scatter_flat(leaf, upd, idx)
