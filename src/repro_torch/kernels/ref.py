"""Plain PyTorch versions of the kernels on the serving path and of the
train route's causal flash attention.

They keep the staging of the JAX package's xla oracles: q scaled in f32 then
rounded to bf16; scores in f32 with ``k_s`` applied to the scores; the mask
value -1e30; softmax in f32; ``v_s`` applied to the probabilities; p rounded
to bf16 before PV; the int8 epilogue evaluated as ``(acc * x_scale) *
w_scale``. The CPU path of every op runs these, and the tests and
``chip_smoke.py`` hold each CUDA kernel against them."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.kv_layout import gather_pages

NEG_INF = -1e30


def ieee_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as an IEEE division on every device. PyTorch's CUDA
    kernel multiplies by the reciprocal of a Python-number divisor, which
    can differ in the last bit; a 0-d tensor divisor (made by a fill, so no
    host sync) takes the true division."""
    return x / x.new_full((), divisor)


def quantize_ref(x: torch.Tensor, dim: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric INT8 along ``dim``: (q int8, scale f32 with ``dim``
    reduced away), x ≈ q * scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = ieee_div(torch.clamp_min(amax, 1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(dim)


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor
                    ) -> torch.Tensor:
    """W8A8 product: x_q (M, K) int8, w_q (K, N) int8, x_scale (M,),
    w_scale (N,) -> (M, N) bf16.

    The integer product is taken in float64, where it is exact here
    (|acc| <= 127² · K < 2⁵³), so the same code runs on the CPU and on a
    card that has no int32 matmul. Rounding it to f32 then matches the
    int32 -> f32 conversion of the reference."""
    acc = (x_q.double() @ w_q.double()).float()
    return ((acc * x_scale[:, None]) * w_scale[None, :]).to(torch.bfloat16)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialized-scores attention: q (B, Sq, Hq, hd), k and v (B, Skv,
    Hkv, hd) with Hq a multiple of Hkv (query head h reads kv head h // G).
    Returns (out (B, Sq, Hq, hd) in q's dtype, f32 log-sum-exp (B, Hq, Sq)
    of the scaled, masked scores).

    Causality is absolute: query i sits at position ``q_offset + i`` and
    sees ``kv_pos <= q_offset + i``. Scores, softmax and PV are f32, as in
    the JAX package's ``flash_attention_ref``."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = torch.arange(skv, device=q.device)[None, :] <= q_pos[:, None]
        s = torch.where(mask, s, s.new_full((), NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1),
                       v.float())
    return (out.reshape(b, sq, hq, hd).to(q.dtype),
            lse.reshape(b, hq, sq))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0
                        ) -> torch.Tensor:
    """The output of ``flash_attention_lse_ref``: the plain version of the
    causal flash kernel (B7), and the oracle of the model's chunked
    flash."""
    return flash_attention_lse_ref(q, k, v, causal, q_offset)[0]


def cached_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_s: Optional[torch.Tensor],
                         v_s: Optional[torch.Tensor],
                         start: torch.Tensor) -> torch.Tensor:
    """Masked GQA attention over a slotted KV window.

    q: (B, Sq, Hq, hd) at absolute positions start..start+Sq-1; k, v:
    (B, W, Hkv, hd) bf16, or int8 with ``k_s``/``v_s`` (B, W, Hkv) f32;
    start: (B,) int. Callers guarantee W >= start+Sq for every consumed
    row. Returns (B, Sq, Hq, hd) bf16."""
    b, sq, hq, hd = q.shape
    w, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = (q.reshape(b, sq, hkv, g, hd).float() * hd ** -0.5
          ).to(torch.bfloat16).float()
    kf = k.to(torch.bfloat16).float()
    s = torch.einsum("bqhgd,bchd->bqhgc", qg, kf)
    if k_s is not None:
        s = s * k_s.permute(0, 2, 1)[:, None, :, None, :]
    limit = start.to(q.device).long()[:, None] + torch.arange(
        sq, device=q.device)[None, :]                          # (B, Sq)
    mask = torch.arange(w, device=q.device)[None, None, :] <= limit[..., None]
    s = torch.where(mask[:, :, None, None, :], s, s.new_full((), NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_s is not None:
        p = p * v_s.permute(0, 2, 1)[:, None, :, None, :]
    out = torch.einsum("bqhgc,bchd->bqhgd", p.to(torch.bfloat16).float(),
                       v.to(torch.bfloat16).float())
    return out.reshape(b, sq, hq, hd).to(torch.bfloat16)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_s: Optional[torch.Tensor],
                         v_s: Optional[torch.Tensor],
                         start: torch.Tensor) -> torch.Tensor:
    """Single-query attention, q (B, Hq, hd): the Sq=1 slice of
    ``cached_attention_ref``."""
    return cached_attention_ref(q[:, None], k, v, k_s, v_s, start)[:, 0]


def _gathered_window(k, v, k_s, v_s, pages):
    """A paged arena's window as contiguous (B, W, ...) tensors: the plain
    paged read is this gather plus the contiguous plain version, which is
    what makes paged equal contiguous bit for bit."""
    g = lambda t: None if t is None else gather_pages(t, pages)
    return g(k), g(v), g(k_s), g(v_s)


def paged_prefill_attention_ref(q, k, v, k_s, v_s, start, pages):
    """q (B, Sq, Hq, hd); k/v (n_pages, page_size, Hkv, hd) arenas (int8 with
    (n_pages, page_size, Hkv) scales when quantized); start (B,); pages
    (B, n_blk) the window prefix of each row's page table."""
    return cached_attention_ref(q, *_gathered_window(k, v, k_s, v_s, pages),
                                start)


def paged_decode_attention_ref(q, k, v, k_s, v_s, start, pages):
    """The Sq=1 slice of ``paged_prefill_attention_ref`` (q (B, Hq, hd))."""
    return decode_attention_ref(q, *_gathered_window(k, v, k_s, v_s, pages),
                                start)
