"""Mixture-of-Experts FFN with no-drop expert dispatch (the JAX package's
``models/moe.py`` on one device: its ``shard_map`` over the ``model`` axis
holds every expert on the one card, so the cross-shard reduction is the
identity).

Params: ``router`` {``w`` (d, E), ``b`` (E,)} in f32, and ``gate``, ``up``
(E, d, ff) and ``down`` (E, ff, d), each ``{"w": bf16}`` or a
``QuantizedLinear`` with per-expert, per-output-channel scales (E, N).

The layer, as the reference's ``_moe_local`` at inference capacity:
  1. f32 router logits plus bias, softmax, top-k, the k gates renormalised;
  2. a zero-filled (E, C, d) dispatch buffer holding each (token, expert)
     pair's token in expert e's block;
  3. the expert SwiGLU over the buffer;
  4. the combine: each contribution, the bf16 expert output times its f32
     gate rounded to bf16, added in bf16 into its token's row, a token's
     pairs in ascending expert id (the order the reference's sorted pairs
     take).
Serving, the Fisher pass and the evaluations run at the reference's
inference capacity, C = the number of tokens N (``ctx.moe_no_drop``). The
reference sorts the pairs by expert and ranks them within it to pick each
one's row in the expert's block (and to drop pairs ranked past C when
training). At C = N no pair is dropped, and an expert appears at most once
in a token's top-k, so the port puts token t in row t of each of its
experts' blocks: every expert gets the same rows, each row is computed on
its own, and the output is the reference's, with no sort by expert and no
ranks.

Training runs the reference's train capacity (``no_drop=False``): C =
``capacity(N, cfg)``, the token-major (token, expert) pairs stably sorted
by expert, a pair's rank its place among its expert's pairs, and a pair
ranked at C or past it dropped: it lands in the (E·C + 1, d) buffer's last
row, the drop bin, and adds exactly 0. ``moe_layer`` also returns the
Switch load-balance and router-z auxiliary losses. Nothing in the forward
adds through atomics (no ``index_add_``, no ``scatter_add_``): the buffer
is filled by ``index_copy`` (whose backward is a gather) and the combine
gathers a token's k rows and adds them in a fixed order; the backward's
scatters put at most one value that is not an exact zero into any row, so
a step is deterministic on the card.

A layer HQP cut to no expert (ROADMAP C12) adds zeros, as its masked
model's zeroed experts do; a layer left with fewer experts than k routes to
those it has (the masked ones it would pick have gate 0).

Batch invariance and CUDA graphs. A token's result does not depend on how
many tokens share the call: the router product runs a row at a time
(``layers.matmul_rows``), the softmax sums with ``layers.row_sum``, top-k
is a stable descending sort (ties go to the lower expert id, as
``lax.top_k``; masked experts tie at exactly 0), the expert products are
row-independent (B1 quantizes per row; the bf16 ones run a row at a time),
and the combine adds in a fixed order, never by atomics. Every shape
follows from the token count alone and nothing reads a device value on
the host, so the dispatch can be captured in a CUDA graph.

The expert products: a ``QuantizedLinear`` leaf runs ``ops.int8_matmul``
(B1 with B2's prologue) once per expert and projection, as the reference's
``jax.vmap`` of ``layers.dense``; bf16 experts run ``layers.dense`` per
expert (a row at a time on the serving route; one product per expert on
the train route, ``batch_invariant=False``: the Fisher pass and Algorithm
1's evaluations)."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import COMPUTE_DTYPE, QuantizedLinear
from repro_torch.roofline import cost

EXPERT_KEYS = ("gate", "up", "down")


# ------------------------------------------------------------------ init
def _expert_weights(gen: torch.Generator, e: int, d_in: int, d_out: int
                    ) -> torch.Tensor:
    """(e, d_in, d_out) bf16 He-init weights drawn one expert at a time: a
    whole draw in f32 would need an f32 temporary of the whole leaf (53.6
    GB at arctic-480b's (128, 7168, 4864))."""
    w = torch.empty((e, d_in, d_out), dtype=COMPUTE_DTYPE, device=gen.device)
    for i in range(e):
        w[i] = L.he_init(gen, (d_in, d_out), COMPUTE_DTYPE)
    return w


def moe_init(gen: torch.Generator, cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {"router": {"w": L.he_init(gen, (d, e), torch.float32),
                       "b": torch.zeros((e,), dtype=torch.float32,
                                        device=gen.device)},
            "gate": {"w": _expert_weights(gen, e, d, ff)},
            "up": {"w": _expert_weights(gen, e, d, ff)},
            "down": {"w": _expert_weights(gen, e, ff, d)}}


def n_experts(p: dict) -> int:
    """The experts of a (possibly compacted) MoE param dict."""
    return p["router"]["w"].shape[-1]


# ------------------------------------------------------------------ routing
def capacity(n_tokens: int, cfg, no_drop: bool = False) -> int:
    """Rows of an expert's block (the reference's ``_capacity``): every
    token at inference capacity, else k·N·cf/E + 1, at least 4 and at most
    N."""
    if no_drop:
        return n_tokens
    m = cfg.moe
    c = int(m.experts_per_token * n_tokens * m.capacity_factor
            / m.n_experts) + 1
    return max(4, min(c, n_tokens))


def _router(x: torch.Tensor, router: dict, batch_invariant: bool):
    """x (N, d) -> (f32 logits plus bias (N, E), their softmax)."""
    logits = L.matmul(x.float(), router["w"].float(),
                      batch_invariant) + router["b"]
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    return logits, ex / L.sum_last(ex, batch_invariant)


def _top_k(probs: torch.Tensor, k: int, batch_invariant: bool):
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k]
    return gates / L.sum_last(gates, batch_invariant), idx[:, :k]


def route(x: torch.Tensor, router: dict, k: int,
          batch_invariant: bool = True):
    """x (N, d) -> (gates (N, k) f32 renormalised over the k, expert ids
    (N, k) int64 in descending probability, the lower id first on a tie)."""
    return _top_k(_router(x, router, batch_invariant)[1], k, batch_invariant)


def expert_counts(flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E,) int64: how many of the expert ids ``flat`` name each expert (a
    comparison table summed, not ``bincount``, which reads its input's
    largest value on the host)."""
    return (flat[:, None] == torch.arange(n_experts, device=flat.device)
            ).sum(0)


def dispatch_plan(idx: torch.Tensor, n_experts: int, cap: int):
    """The train capacity's placement of the token-major pairs of ``idx``
    (N, k), as the reference's: (slot (N·k,) int64, a pair's row of the
    (E·cap + 1)-row buffer, E·cap for a dropped pair; local (N·k,) bool,
    kept; counts (E,) int64, the pairs routed to each expert before the
    drops). A pair's rank is its place in a stable sort by expert."""
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True)[1]
    counts = expert_counts(flat, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    ranked = torch.arange(flat.numel(), device=idx.device) - starts[
        flat[order]]
    rank = torch.empty_like(ranked).index_copy_(0, order, ranked)
    local = rank < cap
    slot = torch.where(local, flat * cap + rank, n_experts * cap)
    return slot, local, counts


def aux_losses(logits: torch.Tensor, probs: torch.Tensor,
               counts: torch.Tensor, k: int, cfg) -> dict:
    """The Switch load-balance loss, E·Σ_e f_e·P_e (f_e the share of the
    N·k pairs routed to e before the drops, P_e the mean probability), and
    the router-z loss, mean(logsumexp(logits)²), each times its weight in
    ``cfg.moe``: 0-d f32, differentiable through the router (the counts
    carry no gradient)."""
    n, e = probs.shape
    frac = counts.float() / (n * k)
    lb = e * torch.sum(frac * probs.mean(0))
    z = torch.mean(torch.logsumexp(logits, -1).square())
    return {"load_balance": lb * cfg.moe.load_balance_loss,
            "router_z": z * cfg.moe.router_z_loss}


# ------------------------------------------------------------------ experts
def _expert(p: dict, e: int) -> dict:
    """Expert ``e``'s gate/up/down as ``layers.mlp`` params."""
    def one(leaf):
        if isinstance(leaf, QuantizedLinear):
            return QuantizedLinear(leaf.w_q[e], leaf.scale[e], leaf.bits)
        return {"w": leaf["w"][e]}
    return {name: one(p[name]) for name in EXPERT_KEYS}


def expert_ffn(xb: torch.Tensor, p: dict,
               batch_invariant: bool = True) -> torch.Tensor:
    """The expert SwiGLU over the dispatch buffer xb (E, C, d) -> (E, C, d)
    bf16: each expert runs ``layers.mlp`` on its own row block e."""
    n = xb.shape[0]
    return cost.catted([L.mlp(xb[e], _expert(p, e), batch_invariant)
                        for e in cost.loop(n, xb)], n, stack=True)


# ------------------------------------------------------------------ forward
def _combine(yb: torch.Tensor, rows: torch.Tensor, scale: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """Step 4: each token-major pair's expert row ``yb[rows]`` times its
    f32 ``scale`` rounded to bf16, a token's k contributions added in bf16
    in ascending expert id -> (N, d)."""
    n, k = idx.shape
    d = yb.shape[-1]
    contrib = (yb.index_select(0, rows).float() * scale[:, None]
               ).to(COMPUTE_DTYPE).reshape(n, k, d)
    by_expert = torch.argsort(idx, dim=-1)
    contrib = torch.gather(contrib, 1, by_expert[..., None].expand(n, k, d))
    out = torch.zeros((n, d), dtype=COMPUTE_DTYPE, device=yb.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_tokens(x: torch.Tensor, p: dict, k: int,
               batch_invariant: bool = True) -> torch.Tensor:
    """x (N, d) -> (N, d) bf16 at inference capacity."""
    return _moe(x, p, k, batch_invariant)[0]


def _moe(x: torch.Tensor, p: dict, k: int, batch_invariant: bool,
         cfg=None, no_drop: bool = True, with_aux: bool = False):
    """x (N, d) -> ((N, d) bf16, aux): at inference capacity with
    ``no_drop``, else at ``cfg``'s train capacity; aux ``aux_losses``' dict
    with ``with_aux``, {} without."""
    n, d = x.shape
    e = n_experts(p)
    k = min(k, e)
    if e == 0:
        zero = x.new_zeros((), dtype=torch.float32)
        return (x.new_zeros((n, d), dtype=COMPUTE_DTYPE),
                {"load_balance": zero, "router_z": zero} if with_aux else {})
    logits, probs = _router(x, p["router"], batch_invariant)
    gates, idx = _top_k(probs, k, batch_invariant)
    pairs = x[:, None].expand(n, k, d).reshape(n * k, d)
    if no_drop:
        # 2: token t's copy for its j-th expert goes to row t of that
        # expert's block: one row per (token, expert) pair
        slot = (idx * n + torch.arange(n, device=x.device)[:, None]
                ).reshape(-1)
        xb = torch.zeros((e * n, d), dtype=x.dtype,
                         device=x.device).index_copy(0, slot, pairs)
        # 3
        yb = expert_ffn(xb.reshape(e, n, d), p,
                        batch_invariant).reshape(e * n, d)
        # 4
        out = _combine(yb, slot, gates.reshape(-1), idx)
        counts = expert_counts(idx.reshape(-1), e) if with_aux else None
    else:
        cap = capacity(n, cfg)
        slot, local, counts = dispatch_plan(idx, e, cap)
        # 2: the (E·C + 1)-row buffer; dropped pairs share its last row
        xb = torch.zeros((e * cap + 1, d), dtype=x.dtype,
                         device=x.device).index_copy(0, slot, pairs)
        # 3
        yb = expert_ffn(xb[:-1].reshape(e, cap, d), p,
                        batch_invariant).reshape(e * cap, d)
        # 4: a dropped pair reads the last kept row times 0
        out = _combine(yb, torch.clamp_max(slot, e * cap - 1),
                       gates.reshape(-1) * local, idx)
    return out, (aux_losses(logits, probs, counts, k, cfg) if with_aux
                 else {})


def moe_layer(p: dict, cfg, x: torch.Tensor, batch_invariant: bool = True,
              no_drop: bool = True, with_aux: bool = False):
    """x (B, S, d) -> ((B, S, d) bf16, aux): at inference capacity with
    ``no_drop``, else at the train capacity; aux as ``_moe``'s."""
    b, s, d = x.shape
    out, aux = _moe(x.reshape(b * s, d), p, cfg.moe.experts_per_token,
                    batch_invariant, cfg, no_drop, with_aux)
    return out.reshape(b, s, d), aux


def moe_forward(p: dict, cfg, x: torch.Tensor,
                batch_invariant: bool = True) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) bf16 at inference capacity (no drops)."""
    return moe_layer(p, cfg, x, batch_invariant)[0]
