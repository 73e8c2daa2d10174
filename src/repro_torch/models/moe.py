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
ranks. MoE training (the capacity factor's drops, the auxiliary losses) is
not ported.

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
def route(x: torch.Tensor, router: dict, k: int,
          batch_invariant: bool = True):
    """x (N, d) -> (gates (N, k) f32 renormalised over the k, expert ids
    (N, k) int64 in descending probability, the lower id first on a tie)."""
    logits = L.matmul(x.float(), router["w"].float(),
                      batch_invariant) + router["b"]
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = ex / L.sum_last(ex, batch_invariant)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k]
    return gates / L.sum_last(gates, batch_invariant), idx[:, :k]


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
    return torch.stack([L.mlp(xb[e], _expert(p, e), batch_invariant)
                        for e in range(xb.shape[0])])


# ------------------------------------------------------------------ forward
def moe_tokens(x: torch.Tensor, p: dict, k: int,
               batch_invariant: bool = True) -> torch.Tensor:
    """x (N, d) -> (N, d) bf16."""
    n, d = x.shape
    e = n_experts(p)
    gates, idx = route(x, p["router"], k, batch_invariant)
    # 2: token t's copy for its j-th expert goes to row t of that expert's
    # block: one row per (token, expert) pair
    slot = (idx * n + torch.arange(n, device=x.device)[:, None]).reshape(-1)
    xb = torch.zeros((e * n, d), dtype=x.dtype, device=x.device).index_copy(
        0, slot, x[:, None].expand(n, k, d).reshape(n * k, d))
    # 3
    yb = expert_ffn(xb.reshape(e, n, d), p, batch_invariant).reshape(e * n,
                                                                     d)
    # 4: a token's k contributions, added in ascending expert id
    contrib = (yb[slot].float() * gates.reshape(-1)[:, None]
               ).to(COMPUTE_DTYPE).reshape(n, k, d)
    by_expert = torch.argsort(idx, dim=-1)
    contrib = torch.gather(contrib, 1, by_expert[..., None].expand(n, k, d))
    out = torch.zeros((n, d), dtype=COMPUTE_DTYPE, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_forward(p: dict, cfg, x: torch.Tensor,
                batch_invariant: bool = True) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) bf16 at inference capacity (no drops)."""
    b, s, d = x.shape
    return moe_tokens(x.reshape(b * s, d), p, cfg.moe.experts_per_token,
                      batch_invariant=batch_invariant).reshape(b, s, d)
