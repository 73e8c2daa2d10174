"""GQA attention with three attend routes: ``train`` (no cache: causal
flash attention over the fresh K/V, differentiable, the route of the HQP
Fisher pass and prune evaluations), ``prefill`` (a chunk of queries against
the KV cache, the ``prefill_attention`` op) and ``decode`` (one query per
row, the ``decode_attention`` op). The cache is laid out (B, S, Hkv, hd),
or is a paged arena (n_pages, page_size, Hkv, hd) addressed through per-row
page tables, and is written in place."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_counts
from repro_torch.kernels.kv_layout import paged_element_index, scatter_flat
from repro_torch.kernels.ref import NEG_INF, ieee_div
from repro_torch.models import layers as L
from repro_torch.roofline import cost

TRAIN, PREFILL, DECODE = "train", "prefill", "decode"
ROUTES = (TRAIN, PREFILL, DECODE)


def attention_init(gen: torch.Generator, cfg) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "wq": L.linear_init(gen, cfg.d_model, cfg.n_heads * hd),
        "wk": L.linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd),
        "wv": L.linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd),
        "wo": L.linear_init(gen, cfg.n_heads * hd, cfg.d_model),
    }


# ------------------------------------------------------------------ flash
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk_kv: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks, in plain tensor ops (the
    JAX package's jnp train route, and the train route's CPU path here).

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd), Hq = G * Hkv. Skv may be
    ragged: K/V are zero-padded to a ``chunk_kv`` multiple and the tail is
    masked by position. Query i sits at position ``q_offset + i`` and, if
    ``causal``, sees ``kv_pos <= q_offset + i``. q is scaled in f32 and
    rounded to bf16; scores, m, l and the accumulator are f32; p is rounded
    to bf16 for PV. Returns (B, Sq, Hq, hd) bf16."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk_kv = min(chunk_kv, skv)
    pad_kv = (-skv) % chunk_kv
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    qs = (q.float() * hd ** -0.5).to(L.COMPUTE_DTYPE).float()
    qs = qs.reshape(b, sq, hkv, g, hd)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    neg = torch.tensor(NEG_INF, device=q.device)
    m = torch.full((b, sq, hkv, g), NEG_INF, device=q.device)
    l = torch.zeros((b, sq, hkv, g), device=q.device)
    acc = torch.zeros((b, sq, hkv, g, hd), device=q.device)
    for j0 in range(0, skv + pad_kv, chunk_kv):
        k_j = k[:, j0:j0 + chunk_kv].to(L.COMPUTE_DTYPE).float()
        v_j = v[:, j0:j0 + chunk_kv].to(L.COMPUTE_DTYPE).float()
        kv_pos = j0 + torch.arange(chunk_kv, device=q.device)
        s = torch.einsum("bqhgd,bchd->bqhgc", qs, k_j)
        # padded tail positions are masked whatever the causal limit
        mask = (kv_pos < skv)[None, :].expand(sq, chunk_kv)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if causal or pad_kv:
            s = torch.where(mask[None, :, None, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgc,bchd->bqhgd", p.to(L.COMPUTE_DTYPE).float(), v_j)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, hq, hd).to(L.COMPUTE_DTYPE)


# ------------------------------------------------------------------ KV cache
def init_kv_cache(batch: int, max_seq: int, n_kv_heads: int, hd: int,
                  quantized: bool, device) -> dict:
    """bf16 K/V, or int8 K/V with per-(batch, pos, head) f32 scales. A paged
    arena is the same call with (total_pages, page_size) in place of
    (batch, max_seq): its leaves have no slot axis."""
    shape = (batch, max_seq, n_kv_heads, hd)
    if quantized:
        return {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=device)}


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (batch, pos, head) symmetric int8. x: (B, S, Hkv, hd)."""
    xf = x.float()
    s = ieee_div(torch.clamp_min(xf.abs().amax(dim=-1), 1e-8), 127.0)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: Union[int, torch.Tensor],
                    pages: Optional[torch.Tensor] = None) -> dict:
    """Write (B, Sn, Hkv, hd) at position ``pos`` in place and return the
    cache. ``pos`` is an int (every row writes at the same offset) or a (B,)
    tensor of per-row offsets (the engine's slots). ``pages`` (B, max_pages)
    int32 marks the cache as a paged arena: logical position p of row b
    lands at ``arena[pages[b, p // page_size], p % page_size]``, with the
    same per-token values (INT8 quantization is per (pos, head)) as the
    contiguous write."""
    if "k_q" in cache:
        kq, ks = _quant_kv(k_new)
        vq, vs = _quant_kv(v_new)
        new = {"k_q": kq, "v_q": vq, "k_s": ks, "v_s": vs}
    else:
        new = {"k": k_new.to(L.COMPUTE_DTYPE), "v": v_new.to(L.COMPUTE_DTYPE)}
    b, sn = k_new.shape[:2]
    if pages is not None:
        pos_b = (pos.to(k_new.device).expand(b)
                 if isinstance(pos, torch.Tensor)
                 else torch.full((b,), pos, device=k_new.device))
        # every leaf shares the arena's (n_pages, page_size) leading dims
        page_size = next(iter(cache.values())).shape[1]
        idx = paged_element_index(pages, pos_b, sn, page_size)
        for key, val in new.items():
            scatter_flat(cache[key], val, idx)
    elif isinstance(pos, torch.Tensor):
        rows = torch.arange(b, device=k_new.device)[:, None]
        cols = pos.to(k_new.device).long()[:, None] + torch.arange(
            sn, device=k_new.device)[None, :]
        for key, val in new.items():
            cache[key][rows, cols] = val
    else:
        for key, val in new.items():
            cache[key][:, pos:pos + sn] = val
    return cache


def attention_forward(p: dict, cfg, x: torch.Tensor,
                      positions: torch.Tensor, cache: Optional[dict] = None,
                      cur_len: Union[int, torch.Tensor, None] = None,
                      window: Optional[int] = None,
                      route: Optional[str] = None,
                      pages: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention sub-block (no norm or residual): project, qk-norm, RoPE,
    then attend by route.

    ``train`` (no cache): causal attention over the fresh K/V. On the card
    it is the flash kernel (``ops.flash_attention``, differentiable); on the
    CPU the chunked online softmax of ``flash_attention``. Its products and
    norms are batched (``batch_invariant=False``): the train route has no
    engine == serial contract.

    ``prefill`` / ``decode`` (a cache): write K/V at ``cur_len``, attend the
    cache through the route's op. ``route=None`` infers train without a
    cache, else decode for a single query and prefill otherwise;
    chunked-prefill callers pass ``"prefill"`` so a 1-token tail chunk keeps
    the prefill numerics. ``window``: static bound on the attended prefix
    (``window >= cur_len + S`` for every consumed row). Head counts come from
    the param shapes, so HQP-compacted artifacts serve as they are; a layer
    cut to no head returns zeros on every route.
    ``pages`` (B, max_pages) int32: the cache is a paged arena, written and
    attended through the page table."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    if cache is None and route not in (None, TRAIN):
        raise ValueError(f"route {route!r} needs a KV cache")
    if cache is not None and route == TRAIN:
        raise ValueError("the train route takes no KV cache")
    batch_invariant = cache is not None
    hd = cfg.resolved_head_dim
    b, s, d = x.shape
    n_heads = L.out_features(p["wq"]) // hd
    n_kv = L.out_features(p["wk"]) // hd
    if n_heads == 0 or n_kv == 0:
        # HQP cut every head (ROADMAP C12): the masked layer's zeroed wo
        # rows give zeros, so the empty one adds zeros, writes no K/V (its
        # cache has no head) and launches nothing
        return x.new_zeros((b, s, d), dtype=L.COMPUTE_DTYPE)
    q = L.dense(x, p["wq"], batch_invariant).reshape(b, s, n_heads, hd)
    k = L.dense(x, p["wk"], batch_invariant).reshape(b, s, n_kv, hd)
    v = L.dense(x, p["wv"], batch_invariant).reshape(b, s, n_kv, hd)
    if cfg.qk_norm:
        q = L.l2norm(q, batch_invariant=batch_invariant)
        k = L.l2norm(k, batch_invariant=batch_invariant)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = cost.differentiable(
            "flash_attention",
            lambda q, k, v: (ops.flash_attention(q, k, v) if q.is_cuda
                             else flash_attention(q, k, v,
                                                  chunk_kv=cfg.attn_chunk_kv)),
            (q, k, v), *flash_counts(q, k, v))
    else:
        update_kv_cache(cache, k, v, cur_len, pages)
        r = route or (DECODE if s == 1 else PREFILL)
        if r == DECODE:
            if s != 1:
                raise ValueError(f"decode attend takes one query, got {s}")
            o = ops.decode_attention(q, cache, cur_len, window, pages)
        else:
            o = ops.prefill_attention(q, cache, cur_len, window, pages)
    return L.dense(o.reshape(b, s, n_heads * hd), p["wo"],
                   batch_invariant)
