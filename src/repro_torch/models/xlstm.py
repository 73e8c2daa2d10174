"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory), the port
of the JAX package's ``models/xlstm.py`` (after arXiv:2405.04517).

mLSTM, per head: a stabilized matrix memory C (hd, hd), a normalizer n
(hd) and a running max m of the log gates,

    m_t = max(m + log σ(f_t), i_t),  C_t = e^(m + log σ(f_t) - m_t) C
          + e^(i_t - m_t) (k_t/√hd) v_tᵀ,  y_t = (q_t C + ...) / max(|q_t·n|, e^-m_t)

The JAX package runs it in a chunkwise form (log-space gate cumulants
inside a chunk, the carried (C, n, m) between chunks) on the train and
prefill routes, and the same code at chunk 1 on decode: two forms that
round differently, and a chunked form that needs the length to be a
multiple of its chunk (ROADMAP C10: a 40-token prompt at chunk 32
raises). Here the routes that carry a state (prefill chunks, decode steps,
a whole prompt) step the chunk-1 expression in order, position by
position, with the reference's casts (C and n to bf16 for the query's
products, the gated score to bf16 before it meets v): a decode step, a
prefill chunk and a whole prompt give the same bits however the prompt is
cut. The train route (``lm.forward``: the Fisher pass and the prune
evaluations) keeps the chunkwise form, whose autograd keeps one C a
chunk, not one a position, with a shorter last chunk where the length is
not a multiple of ``XLSTMConfig.chunk`` (C10's repair).

sLSTM keeps its nonlinear h -> gate recurrence, so every route steps it,
as the reference's does; its recurrent matrices are block-diagonal (one
(hd, hd) block a head).

Batch invariance (``layers``): on the routes that carry a state, the
projections go through ``dense`` and ``matmul_rows`` (the f32 gate
products a row at a time, in true f32 on the card: PyTorch's default
keeps TF32 off), the per-head products a row at a time
(``head_matmul``; the sLSTM's four recurrent blocks side by side in one
product, as the mLSTM's two f32 gates are in one ``matmul_rows``; wq, wk
and wv apart, as their bf16 outputs would round apart), the query's
products with C and n a batch row at a time, and q·k and the norms
through ``row_sum``; the rest is elementwise, its transcendental
functions built from ``exp`` and ``log`` (``layers.silu``, ``sigmoid``,
``tanh``, ``softplus``).

Decode states are dicts, ``{"C", "n", "m"}`` for mLSTM and ``{"h", "c",
"n", "m"}`` for sLSTM, all f32 with the batch axis first; neither has a
``k`` or ``k_q`` key, so ``serving.state_pool`` keeps them as recurrent
state. A forward returns a new state and never writes the one it was
given. An mLSTM block's head count is read off its params (its head width
is fixed, HQP's ``mlstm_heads`` family cuts heads), so a compacted block
sizes its own state."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.roofline import cost

NEG = -1e30


# ===================================================================== shared
def head_matmul(x: torch.Tensor, w: torch.Tensor,
                batch_invariant: bool) -> torch.Tensor:
    """x (..., H, d) @ w (H, d, e), head by head -> (..., H, e) in the
    inputs' dtype. Batch-invariant: one (H, 1, d) @ (H, d, e) product a
    row of the leading axes, so a row's bits are those of a one-row call."""
    if not batch_invariant:
        return torch.einsum("...hd,hde->...he", x, w)
    n = math.prod(x.shape[:-2])
    rows = x.reshape(n, *x.shape[-2:])
    out = cost.catted([torch.matmul(rows[i][:, None, :], w)[None, :, 0]
                       for i in cost.loop(n, rows)], n)
    return out.reshape(*x.shape[:-1], w.shape[-1])


# ===================================================================== mLSTM
def mlstm_init(gen: torch.Generator, cfg) -> dict:
    """in_proj (d, 2·d_in), out_proj (d_in, d) and the per-head wq, wk, wv
    (h, hd, hd) in bf16; the gates' w_i, w_f (d_in, h) with their biases
    (the forget gate's at 3: open) and the per-head norm's g in f32, as
    the reference's."""
    d = cfg.d_model
    d_in = int(cfg.xlstm.proj_factor_mlstm * d)
    h = cfg.n_heads
    hd = d_in // h
    dev = gen.device

    def blk():
        return (torch.randn((h, hd, hd), generator=gen, device=dev)
                * hd ** -0.5).to(L.COMPUTE_DTYPE)
    return {
        "in_proj": L.linear_init(gen, d, 2 * d_in),
        "wq": blk(), "wk": blk(), "wv": blk(),
        "w_i": {"w": L.he_init(gen, (d_in, h), torch.float32),
                "b": torch.zeros((h,), dtype=torch.float32, device=dev)},
        "w_f": {"w": L.he_init(gen, (d_in, h), torch.float32),
                "b": torch.full((h,), 3.0, dtype=torch.float32,
                                device=dev)},
        "norm": {"g": torch.ones((d_in,), dtype=torch.float32, device=dev)},
        "out_proj": L.linear_init(gen, d_in, d),
    }


def head_width(cfg) -> int:
    """The mLSTM head width: HQP cuts heads, never this."""
    return int(cfg.xlstm.proj_factor_mlstm * cfg.d_model) // cfg.n_heads


def init_mlstm_state(batch: int, cfg, d_in: Optional[int] = None,
                     device=None) -> dict:
    """A zero state. ``d_in``: the inner width of an HQP-compacted block
    (its ``in_proj``'s output over 2), which fixes its head count."""
    hd = head_width(cfg)
    if d_in is None:
        d_in = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    h = d_in // hd
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.zeros((batch, h), **f32)}


def _mlstm_chunk(q, k, v, i_pre, log_f, carry):
    """The reference's ``_mlstm_chunk``: one chunk of c positions,
    vectorized over (B, H). q, k, v (B, H, c, hd) bf16; i_pre, log_f (B,
    H, c) f32; carry (C (B, H, hd, hd), n (B, H, hd), m (B, H)) f32.
    Returns (y (B, H, c, hd) f32, the carry after the chunk). The bf16
    products accumulate in f32 as the reference's ``preferred_element_type
    = f32``: exact products of bf16 values, summed in f32."""
    bf16 = L.COMPUTE_DTYPE
    c, hd = q.shape[2], q.shape[3]
    cmat, n, m = carry
    b = torch.cumsum(log_f, -1)
    total_f = b[..., -1]
    lmat = b[..., :, None] - b[..., None, :] + i_pre[..., None, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    lmat = torch.where(tri, lmat, NEG)
    m_intra = lmat.amax(-1)
    m_inter = m[..., None] + b
    m_t = torch.maximum(m_inter, m_intra)
    p = torch.exp(lmat - m_t[..., None])
    e_inter = torch.exp(m_inter - m_t)
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = (qf @ kf.transpose(-1, -2)) * hd ** -0.5
    sp = scores * p
    qc = qf @ cmat.to(bf16).float()
    y_num = qc * e_inter[..., None] + sp.to(bf16).float() @ vf
    n_num = ((qf @ n.to(bf16).float()[..., None])[..., 0] * e_inter
             + sp.sum(-1))
    denom = torch.maximum(n_num.abs(), torch.exp(-m_t))[..., None]
    y = y_num / denom
    m_next = torch.maximum(m + total_f,
                           (total_f[..., None] - b + i_pre).amax(-1))
    decay_old = torch.exp(m + total_f - m_next)
    w_s = torch.exp(total_f[..., None] - b + i_pre - m_next[..., None])
    kw = kf * w_s[..., None] * hd ** -0.5
    c_new = cmat * decay_old[..., None, None] + kw.transpose(-1, -2) @ vf
    n_new = n * decay_old[..., None] + kw.sum(-2)
    return y, (c_new, n_new, m_next)


def _rows_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (B, H, m, k) @ b (B, H, k, n) -> (B, H, m, n), a batch row at a
    time (a batched product's algorithm may follow the batch count)."""
    n = a.shape[0]
    return cost.catted([torch.matmul(a[i:i + 1], b[i:i + 1])
                        for i in cost.loop(n, a)], n)


def mlstm_steps(q, k, v, i_pre, log_f, state: dict):
    """The chunk-1 expression stepped in order over the S positions from
    ``state``: q, k, v (B, S, H, hd) bf16, i_pre and log_f (B, S, H) f32.
    Returns (y (B, S, H, hd) f32, the new state). At one position this is
    the reference's ``_mlstm_chunk`` at c = 1 (its decode form), with its
    casts: there b_t - b_s = 0 and the carry's m equals m_t, so the decay
    and the key's weight are the output's e_inter and p; the sums (the
    dot products, the state's multiply-add in one ``addcmul``) may round
    in another order than XLA's. The state-free parts (q·k, the f32
    copies) are taken for all S positions at once."""
    bf16 = L.COMPUTE_DTYPE
    cmat, n, m = state["C"], state["n"], state["m"]
    scale = q.shape[-1] ** -0.5
    q, k, v = q.float(), k.float(), v.float()
    qk = L.row_sum(q * k)[..., 0]                           # (B, S, H)
    ys = []
    for t in cost.loop(q.shape[1], q):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]
        it, ft = i_pre[:, t], log_f[:, t]
        m_inter = m + ft
        m_t = torch.maximum(m_inter, it)
        p = torch.exp(it - m_t)
        e = torch.exp(m_inter - m_t)
        sp = qk[:, t] * scale * p
        q4 = qt[:, :, None, :]
        y_num = (_rows_matmul(q4, cmat.to(bf16).float())[:, :, 0]
                 * e[..., None] + sp.to(bf16).float()[..., None] * vt)
        n_num = (_rows_matmul(q4, n.to(bf16).float()[..., None])[..., 0, 0]
                 * e + sp)
        denom = torch.maximum(n_num.abs(), torch.exp(-m_t))
        ys.append(y_num / denom[..., None])
        kw = kt * p[..., None] * scale
        cmat = torch.addcmul(cmat * e[..., None, None], kw[..., :, None],
                             vt[..., None, :])
        n = n * e[..., None] + kw
        m = m_t
    return (cost.catted(ys, q.shape[1], 1, stack=True),
            {"C": cmat, "n": n, "m": m})


def mlstm_forward(p: dict, cfg, x: torch.Tensor,
                  state: Optional[dict] = None,
                  batch_invariant: bool = True
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) bf16 -> (out (B, S, d) bf16, the new state). Without
    ``state``: the train route, chunkwise from zero state, and no state
    returned."""
    bi = batch_invariant
    b_sz, seq, _ = x.shape
    hd = p["wq"].shape[-1]                        # per-head width (fixed)
    d_in = L.out_features(p["in_proj"]) // 2
    h = d_in // hd                                # shape-derived (pruning)
    xz = L.dense(x, p["in_proj"], bi)
    xin, z = xz[..., :d_in], xz[..., d_in:]
    xh = xin.reshape(b_sz, seq, h, hd)
    q, k, v = (head_matmul(xh, p[w], bi) for w in ("wq", "wk", "wv"))
    gates = L.matmul(xin.float(), torch.cat([p["w_i"]["w"], p["w_f"]["w"]],
                                            1), bi)           # (B, S, 2H)
    i_pre = gates[..., :h] + p["w_i"]["b"]
    # log σ(f) = -softplus(-f), as jax.nn.log_sigmoid forms it
    log_f = -L.softplus(-(gates[..., h:] + p["w_f"]["b"]))
    if state is not None:
        y, new_state = mlstm_steps(q, k, v, i_pre, log_f, state)
    else:
        new_state = None
        zero = init_mlstm_state(b_sz, cfg, d_in, x.device)
        carry = (zero["C"], zero["n"], zero["m"])
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B,H,S,hd)
        ih, fh = i_pre.transpose(1, 2), log_f.transpose(1, 2)
        ys = []
        n_chunks = -(-seq // cfg.xlstm.chunk)
        for c in cost.loop(n_chunks, x):
            sl = slice(c * cfg.xlstm.chunk, (c + 1) * cfg.xlstm.chunk)
            y_c, carry = _mlstm_chunk(qh[:, :, sl], kh[:, :, sl],
                                      vh[:, :, sl], ih[..., sl],
                                      fh[..., sl], carry)
            ys.append(y_c)
        y = cost.catted(ys, n_chunks, 2).transpose(1, 2)      # (B,S,H,hd)
    # per-head norm: keeps the masked-prune model equal to the compacted
    var = L.sum_last(y * y, bi) / hd
    y = (y * torch.rsqrt(var + cfg.norm_eps)).reshape(b_sz, seq, d_in)
    y = (y * p["norm"]["g"]).to(L.COMPUTE_DTYPE)
    out = L.dense(y * L.silu(z), p["out_proj"], bi)
    return out, new_state


# ===================================================================== sLSTM
GATES = ("z", "i", "f", "o")


def slstm_init(gen: torch.Generator, cfg) -> dict:
    """The input gates' wz, wi, wf, wo (d, d) and the recurrent blocks
    rz, ri, rf, ro (h, hd, hd) in f32, their biases (the forget gate's at
    3), the norm's g, and the gated up (d, 2·d_up) / down (d_up, d) MLP in
    bf16, as the reference's."""
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    d_up = int(cfg.xlstm.proj_factor_slstm * d)
    dev = gen.device
    p = {f"w{g}": L.he_init(gen, (d, d), torch.float32) for g in GATES}
    for g in GATES:
        p[f"r{g}"] = (torch.randn((h, hd, hd), generator=gen, device=dev)
                      * hd ** -0.5)
    for g in GATES:
        p[f"b_{g}"] = torch.full((d,), 3.0 if g == "f" else 0.0,
                                 dtype=torch.float32, device=dev)
    p["norm"] = {"g": torch.ones((d,), dtype=torch.float32, device=dev)}
    p["up"] = L.linear_init(gen, d, 2 * d_up)
    p["down"] = L.linear_init(gen, d_up, d)
    return p


def init_slstm_state(batch: int, cfg, device=None) -> dict:
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("h", "c", "n", "m")}


def slstm_steps(p: dict, gates: torch.Tensor, state: dict, n_heads: int,
                batch_invariant: bool) -> Tuple[torch.Tensor, dict]:
    """The recurrence stepped in order over the S positions of ``gates``
    (B, S, 4, d) f32, the input's products with wz, wi, wf, wo. Returns
    (h of every position (B, S, d) f32, the new state)."""
    h, c, n, m = (state[k] for k in ("h", "c", "n", "m"))
    b_sz, d = h.shape
    hd = d // n_heads
    r_all = torch.cat([p[f"r{x}"] for x in GATES], -1)      # (H, hd, 4hd)
    hs = []
    for t in cost.loop(gates.shape[1], gates):
        g = gates[:, t]
        rec = head_matmul(h.reshape(b_sz, n_heads, hd), r_all,
                          batch_invariant)
        rz, ri, rf, ro = (rec[..., j * hd:(j + 1) * hd].reshape(b_sz, d)
                          for j in range(4))
        z = L.tanh(g[:, 0] + rz + p["b_z"])
        i_pre = g[:, 1] + ri + p["b_i"]
        f_pre = g[:, 2] + rf + p["b_f"]
        o = L.sigmoid(g[:, 3] + ro + p["b_o"])
        m_new = torch.maximum(f_pre + m, i_pre)
        i = torch.exp(i_pre - m_new)
        f = torch.exp(f_pre + m - m_new)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    return (cost.catted(hs, gates.shape[1], 1, stack=True),
            {"h": h, "c": c, "n": n, "m": m})


def slstm_forward(p: dict, cfg, x: torch.Tensor,
                  state: Optional[dict] = None,
                  batch_invariant: bool = True
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) bf16 -> (out (B, S, d) bf16, the new state, or None
    without ``state``: the train route, from zero state)."""
    bi = batch_invariant
    xf = x.float()
    gates = torch.stack([L.matmul(xf, p[f"w{g}"], bi) for g in GATES], 2)
    start = (state if state is not None
             else init_slstm_state(x.shape[0], cfg, x.device))
    y, new_state = slstm_steps(p, gates, start, cfg.n_heads, bi)
    y = L.rmsnorm(y, p["norm"], cfg.norm_eps, bi)
    d_up = L.out_features(p["up"]) // 2
    ug = L.dense(y, p["up"], bi)
    out = L.dense(ug[..., :d_up] * L.silu(ug[..., d_up:]), p["down"], bi)
    return out, (new_state if state is not None else None)
