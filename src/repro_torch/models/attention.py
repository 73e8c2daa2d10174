"""GQA attention over a (possibly INT8) KV cache, with two attend routes:
``prefill`` (a chunk of queries, the ``prefill_attention`` op) and
``decode`` (one query per row, the ``decode_attention`` op). The cache is
laid out (B, S, Hkv, hd), or is a paged arena (n_pages, page_size, Hkv, hd)
addressed through per-row page tables, and is written in place."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.kv_layout import paged_element_index, scatter_flat
from repro_torch.kernels.ref import ieee_div
from repro_torch.models import layers as L

PREFILL, DECODE = "prefill", "decode"
ROUTES = (PREFILL, DECODE)


def attention_init(gen: torch.Generator, cfg) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "wq": L.linear_init(gen, cfg.d_model, cfg.n_heads * hd),
        "wk": L.linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd),
        "wv": L.linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd),
        "wo": L.linear_init(gen, cfg.n_heads * hd, cfg.d_model),
    }


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
                      positions: torch.Tensor, cache: dict,
                      cur_len: Union[int, torch.Tensor],
                      window: Optional[int] = None,
                      route: Optional[str] = None,
                      pages: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention sub-block (no norm or residual): project, qk-norm, RoPE,
    write K/V at ``cur_len``, attend the cache through the route's op.

    ``route=None`` infers decode for a single query and prefill otherwise;
    chunked-prefill callers pass ``"prefill"`` so a 1-token tail chunk keeps
    the prefill numerics. ``window``: static bound on the attended prefix
    (``window >= cur_len + S`` for every consumed row). Head counts come from
    the param shapes, so HQP-compacted artifacts serve as they are.
    ``pages`` (B, max_pages) int32: the cache is a paged arena, written and
    attended through the page table."""
    if cache is None:
        raise NotImplementedError("the train route (no KV cache) is not "
                                  "ported yet")
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    n_heads = L.out_features(p["wq"]) // hd
    n_kv = L.out_features(p["wk"]) // hd
    q = L.dense(x, p["wq"]).reshape(b, s, n_heads, hd)
    k = L.dense(x, p["wk"]).reshape(b, s, n_kv, hd)
    v = L.dense(x, p["wv"]).reshape(b, s, n_kv, hd)
    if cfg.qk_norm:
        q, k = L.l2norm(q), L.l2norm(k)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    update_kv_cache(cache, k, v, cur_len, pages)
    r = route or (DECODE if s == 1 else PREFILL)
    if r == DECODE:
        if s != 1:
            raise ValueError(f"decode attend takes one query, got {s}")
        o = ops.decode_attention(q, cache, cur_len, window, pages)
    else:
        o = ops.prefill_attention(q, cache, cur_len, window, pages)
    return L.dense(o.reshape(b, s, n_heads * hd), p["wo"])
