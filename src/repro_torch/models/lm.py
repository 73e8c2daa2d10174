"""Decoder LM over the ``attn``, ``mamba``, ``mlstm`` and ``slstm`` block
kinds: the dense GQA family; the MoE family, whose layers put
``models/moe.py``'s experts in place of the MLP (arctic-480b keeps a dense
residual MLP beside them); the hybrid family (jamba), whose ``mamba``
layers put ``models/ssm.py``'s mixer in place of attention, each followed
by an MLP or the experts; and the xLSTM family, whose ``mlstm`` and
``slstm`` blocks (``models/xlstm.py``) are a norm and the block alone, with
no FFN. A config with a frontend (phi-3-vision, musicgen) prepends the
frontend linear's map of precomputed embeddings to the token stream.

Params are plain dicts: ``{"embed": {"table"}, "blocks": [per-layer dict],
"final_norm": {"g"}}`` (plus ``"unembed"`` when embeddings are untied, and
``"frontend": {"w"}`` for a config with a frontend). The
JAX package stacks the layers of each position of the pattern's period and
scans them; here ``blocks`` is a list in layer order and the forward pass
is a Python loop over it (``weights`` converts).

A decode state holds one cache a layer: an attention layer's KV cache,
written in place, or a Mamba, mLSTM or sLSTM layer's recurrent state,
which each step replaces (the block's forward returns a new one).

Two kinds of pass: ``forward`` / ``loss_fn`` run the whole sequence on the
train route (no cache, differentiable: training, the HQP Fisher pass and
the prune evaluations), ``decode_step`` runs prefill chunks and decode
steps against the KV cache (serving), and ``verify_step`` scores a
speculative candidate chunk at every position."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.compress.quantize import (quantize_linear,
                                           quantize_lm_params)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.roofline import cost

VOCAB_PAD = 256


def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 256; the padding logits are
    masked to -1e30, so the distribution over real tokens is unchanged."""
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


KINDS = ("attn", "mamba", "mlstm", "slstm")
XLSTM_KINDS = ("mlstm", "slstm")      # a norm and the block: no FFN


def layer_specs(cfg) -> Tuple[Tuple[str, bool], ...]:
    """(block kind, is MoE) of every layer, as the JAX package's. Raises
    ``NotImplementedError`` for a block kind the port does not run."""
    other = set(cfg.pattern) - set(KINDS)
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(other)} are not ported; the "
            f"port runs {list(KINDS)} layers")
    return tuple((kind, cfg.is_moe_layer(i))
                 for i, kind in enumerate(cfg.pattern))


def least_period(seq: Sequence) -> int:
    """The least p dividing len(seq) with seq[i] == seq[i % p] for all i."""
    n = len(seq)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and all(seq[i] == seq[i % p]
                                      for i in range(n)))


def pattern_period(cfg) -> int:
    """The least period of ``layer_specs``: the JAX package stacks layer
    ``g·period + j`` at ``blocks[j][g]``."""
    return least_period(layer_specs(cfg))


def layer_order(cfg, n: int, like: torch.Tensor):
    """The indices 0..n-1 of the layers a pass runs, in order, grouped by
    the pattern's period (the JAX package scans these groups). On the meta
    device (``cost.loop``) the groups between the first and the last run
    once and count for all of them, as the scan's body counts its trip
    count: the dry run's layers of one period position share their
    shapes."""
    period = pattern_period(cfg)
    if n % period:
        yield from range(n)
        return
    for g in cost.loop(n // period, like):
        yield from range(g * period, (g + 1) * period)


def is_recurrent(cfg) -> bool:
    """Whether a layer keeps recurrent state (a ``mamba``, ``mlstm`` or
    ``slstm`` block): state that a prefix cache cannot share, that a
    speculative rollback by position cannot rewind."""
    return any(kind != "attn" for kind in cfg.pattern)


# ------------------------------------------------------------------ init
_INIT = {"attn": A.attention_init, "mamba": S.mamba_init,
         "mlstm": X.mlstm_init, "slstm": X.slstm_init}


def _block_init(gen: torch.Generator, cfg, kind: str, is_moe: bool) -> dict:
    p = {"norm1": L.rmsnorm_init(cfg.d_model, gen.device),
         kind: _INIT[kind](gen, cfg)}
    if kind in XLSTM_KINDS:
        return p
    p["norm2"] = L.rmsnorm_init(cfg.d_model, gen.device)
    if is_moe:
        p["moe"] = M.moe_init(gen, cfg)
        if cfg.moe.dense_residual:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff)
    return p


def init_params(cfg, seed: int = 0, device=None,
                quantized: bool = False) -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    target device (they differ from the JAX package's for the same seed;
    tests carry weights across with ``repro_torch.weights``). With
    ``quantized`` each layer goes through ``quantize_lm_params`` as soon as
    it is drawn, before the next one is: the INT8 model of a config whose
    bf16 layers do not fit the card together, the same bits as
    ``quantize_lm_params(init_params(cfg, seed))``.

    A config with a frontend gets a top-level (d_model, d_model)
    ``frontend`` linear, as the JAX package's, drawn after every other
    leaf: the rest of the tree is the one the config without a frontend
    draws, bit for bit."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    v_pad = padded_vocab(cfg)
    params: Dict[str, Any] = {"embed": L.embed_init(gen, v_pad, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.embed_init(gen, v_pad, cfg.d_model)
    blocks = []
    for kind, is_moe in layer_specs(cfg):
        blk = _block_init(gen, cfg, kind, is_moe)
        blocks.append(quantize_lm_params(blk) if quantized else blk)
    if cfg.n_frontend:
        # the reference's key order: the frontend before the blocks
        fr = L.linear_init(gen, cfg.d_model, cfg.d_model)
        params["frontend"] = quantize_linear(fr) if quantized else fr
    params["blocks"] = blocks
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dev)
    return params


def params_device(params: dict) -> torch.device:
    return params["embed"]["table"].device


# ------------------------------------------------------------------ logits
def unembed_params(params: dict, cfg) -> dict:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def logits_fn(params: dict, cfg, hidden: torch.Tensor,
              batch_invariant: bool = True) -> torch.Tensor:
    """f32 logits over the padded vocab, the padding masked to -1e30 (a
    Python scalar: a tensor made from it would be a host-to-device copy,
    which a CUDA-graph capture refuses)."""
    logits = L.unembed(unembed_params(params, cfg), hidden, batch_invariant)
    v_pad = logits.shape[-1]
    if v_pad == cfg.vocab_size:
        return logits
    mask = torch.arange(v_pad, device=logits.device) < cfg.vocab_size
    return torch.where(mask, logits, -1e30)


# ------------------------------------------------------------------ blocks
def ffn(p: dict, cfg, h: torch.Tensor, batch_invariant: bool) -> torch.Tensor:
    """A layer's FFN on its normed input: the SwiGLU MLP, or the experts
    (plus, beside them, arctic's dense residual MLP, added in bf16)."""
    if "moe" not in p:
        return L.mlp(h, p["mlp"], batch_invariant)
    out = M.moe_forward(p["moe"], cfg, h, batch_invariant)
    if "mlp" in p:
        out = out + L.mlp(h, p["mlp"], batch_invariant)
    return out


def ffn_aux(p: dict, cfg, h: torch.Tensor, batch_invariant: bool,
            moe_no_drop: bool = True, with_aux: bool = False):
    """``ffn`` -> (out, aux): the experts at inference capacity with
    ``moe_no_drop``, else at the train capacity (``moe.moe_layer``); aux
    their auxiliary losses with ``with_aux``, else {} (and {} for an
    MLP)."""
    if "moe" not in p or (moe_no_drop and not with_aux):
        return ffn(p, cfg, h, batch_invariant), {}
    out, aux = M.moe_layer(p["moe"], cfg, h, batch_invariant, moe_no_drop,
                           with_aux)
    if "mlp" in p:
        out = out + L.mlp(h, p["mlp"], batch_invariant)
    return out, aux


def _recurrent(kind: str):
    """A recurrent block's forward, looked up on its module at the call
    (so that a wrapper set there, a fault injector or a profiler range,
    takes effect)."""
    return {"mamba": S.mamba_forward, "mlstm": X.mlstm_forward,
            "slstm": X.slstm_forward}[kind]


# ------------------------------------------------------------------ train
def embed_inputs(params: dict, cfg, tokens: torch.Tensor,
                 embeds: Optional[torch.Tensor] = None,
                 batch_invariant: bool = True) -> torch.Tensor:
    """The model's input sequence (B, n + S, d) bf16: the token embeddings
    of ``tokens`` (B, S), after the ``frontend`` linear's map of
    ``embeds`` (B, n, d) when the config has a frontend and ``embeds`` is
    given (n = 0 otherwise), as the JAX package prepends them."""
    x = L.embed_lookup(params["embed"], tokens)
    if embeds is None or not cfg.n_frontend:
        return x
    fr = L.dense(embeds.to(L.COMPUTE_DTYPE), params["frontend"],
                 batch_invariant)
    return torch.cat([fr, x], dim=1)


def frontend_embeds(cfg, batch: int, device) -> torch.Tensor:
    """The launchers' stand-in for a frontend's precomputed embeddings, as
    the JAX package's: zeros (batch, n_fr, d_model) bf16."""
    return torch.zeros((batch, cfg.n_frontend, cfg.d_model),
                       dtype=torch.bfloat16, device=device)


def forward(params: dict, cfg, batch: dict, with_aux: bool = False,
            moe_no_drop: bool = True):
    """Final hidden states (B, n_fr + S, d) of ``batch["tokens"]`` (B, S)
    on the train route: every attention layer attends its own fresh K/V
    causally, every Mamba, mLSTM or sLSTM layer runs its recurrence from
    zero state (the mLSTM in its chunkwise form: ``xlstm.mlstm_forward``).
    A config with a frontend takes ``batch["embeds"]`` (B, n_fr, d), whose
    map by the ``frontend`` linear the tokens follow (``embed_inputs``).

    ``moe_no_drop`` is the reference's ``ctx.moe_no_drop``: True (the
    Fisher pass, the evaluations) runs the experts at inference capacity,
    False at the capacity factor's, dropping what overflows (training).
    ``with_aux`` returns (hidden, aux), aux the MoE layers' load-balance
    and router-z losses summed in layer order ({} when no layer is MoE),
    as the JAX package's ``forward``; without it the hidden states
    alone."""
    x = embed_inputs(params, cfg, batch["tokens"],
                     batch["embeds"] if cfg.n_frontend else None,
                     batch_invariant=False)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    specs = layer_specs(cfg)
    aux = ({"load_balance": x.new_zeros((), dtype=torch.float32),
            "router_z": x.new_zeros((), dtype=torch.float32)}
           if with_aux and any(m for _, m in specs) else {})
    for i in layer_order(cfg, min(len(specs), len(params["blocks"])), x):
        kind, p = specs[i][0], params["blocks"][i]
        h = L.rmsnorm(x, p["norm1"], cfg.norm_eps, batch_invariant=False)
        if kind == "attn":
            x = x + A.attention_forward(p["attn"], cfg, h, positions,
                                        route=A.TRAIN)
        else:
            x = x + _recurrent(kind)(p[kind], cfg, h,
                                     batch_invariant=False)[0]
        if kind in XLSTM_KINDS:
            continue
        h = L.rmsnorm(x, p["norm2"], cfg.norm_eps, batch_invariant=False)
        out, aux_j = ffn_aux(p, cfg, h, False, moe_no_drop, with_aux)
        if aux_j:
            aux = {k: aux[k] + aux_j[k] for k in aux}
        x = x + out
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps,
                  batch_invariant=False)
    return (x, aux) if with_aux else x


def loss_fn(params: dict, cfg, batch: dict, ce_chunk: int = 512,
            with_aux: bool = False, moe_no_drop: bool = True):
    """Mean next-token cross-entropy over the text positions: hidden
    position n_fr + i predicts token i + 1 (n_fr the frontend's
    positions, 0 without one). The sequence is cut into chunks of
    ``ce_chunk`` positions, so the
    (B, S, V) logits are never whole (peak (B, ce_chunk, V)); the padded
    vocab is masked. With ``with_aux`` the MoE auxiliary losses are added
    to it and it returns (loss, aux), as the JAX package's ``loss_fn``;
    ``moe_no_drop`` as in ``forward``."""
    out = forward(params, cfg, batch, with_aux, moe_no_drop)
    hidden, aux = out if with_aux else (out, {})
    tokens = batch["tokens"]
    b, st = tokens.shape
    n_fr = cfg.n_frontend
    h, targets = hidden[:, n_fr:n_fr + st - 1], tokens[:, 1:]
    n_tok = h.shape[1]
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, n_tok, ce_chunk):
        lg = logits_fn(params, cfg, h[:, c0:c0 + ce_chunk],
                       batch_invariant=False)
        gold = torch.gather(lg, -1,
                            targets[:, c0:c0 + ce_chunk, None].long())
        total = total + (torch.logsumexp(lg, -1) - gold[..., 0]).sum()
    loss = total / (b * n_tok)
    if not with_aux:
        return loss
    for v in aux.values():
        loss = loss + v
    return loss, aux


# ------------------------------------------------------------------ decode
def init_decode_state(cfg, batch: int, max_seq: int,
                      params: Optional[dict] = None,
                      per_slot_pos: bool = False, quantized_kv: bool = False,
                      device=None,
                      kv_pages: Optional[Tuple[int, int]] = None) -> dict:
    """Per-layer caches plus the current length: a KV cache for each
    attention layer, a zero recurrent state for each Mamba, mLSTM or sLSTM
    layer (``ssm.init_mamba_state``, ``xlstm.init_mlstm_state``,
    ``xlstm.init_slstm_state``).

    ``pos`` is an int (the whole batch at one position: the serial path) or,
    with ``per_slot_pos``, a (batch,) int32 tensor (the engine's slots).
    With ``params`` the KV, Mamba and mLSTM widths derive from the param
    shapes (an mLSTM's from its ``in_proj``, as the reference's), so
    HQP-compacted artifacts size their own caches. ``kv_pages=(total_pages,
    page_size)`` makes every KV cache a paged arena (total_pages, page_size,
    Hkv, hd) with no slot axis, shared through page tables the caller owns
    (``serving.state_pool``); a recurrent state keeps its batch axis (it is
    O(1) a slot and not indexed by position)."""
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    kv_b, kv_s = kv_pages if kv_pages is not None else (batch, max_seq)
    caches = []
    for i, (kind, _) in enumerate(layer_specs(cfg)):
        blk = params["blocks"][i] if params is not None else None
        if kind == "mamba":
            d_in = (blk["mamba"]["conv_w"].shape[-1] if blk is not None
                    else None)
            caches.append(S.init_mamba_state(batch, cfg, d_in, dev))
            continue
        if kind == "mlstm":
            d_in = (L.out_features(blk["mlstm"]["in_proj"]) // 2
                    if blk is not None else None)
            caches.append(X.init_mlstm_state(batch, cfg, d_in, dev))
            continue
        if kind == "slstm":
            caches.append(X.init_slstm_state(batch, cfg, dev))
            continue
        n_kv = (L.out_features(blk["attn"]["wk"]) // hd
                if blk is not None else cfg.n_kv_heads)
        caches.append(A.init_kv_cache(kv_b, kv_s, n_kv, hd, quantized_kv,
                                      dev))
    pos = (torch.zeros((batch,), dtype=torch.int32, device=dev)
           if per_slot_pos else 0)
    return {"caches": caches, "pos": pos}


def decode_step(params: dict, cfg, state: dict, tokens: torch.Tensor,
                window: Optional[int] = None, route: Optional[str] = None,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, dict]:
    """tokens (B, S_new) at positions ``state["pos"]`` onward (an int, or a
    (B,) tensor of per-row positions). Writes the new K/V into the caches in
    place and returns (logits (B, 1, V_pad) f32 of the LAST position, the
    state with ``pos`` advanced by S_new, each recurrent layer's new state
    in place of its old one, which is not written).

    ``embeds`` (B, n, d), for a config with a frontend, are the frontend's
    precomputed embeddings, mapped and prepended to the tokens (a prefill
    call): they take positions ``pos`` .. ``pos + n - 1`` and ``pos``
    advances by n + S_new, as in the JAX package.

    Only the last position's logits are computed: every caller (engine
    prefill and decode, serial decode) reads only those, and the unembed is
    the largest product of the step. ``window`` and ``route`` are as in
    ``attention.attention_forward``.

    ``state["pages"]`` (B, max_pages) int32, when present, marks the KV
    caches as paged arenas: every KV write and attend goes through the
    per-row page table. The table is an input only and the returned state
    never carries it: the engine redirects rows to the trash page between
    dispatches, which a pass-through would undo."""
    x, new = _cached_layers(params, cfg, state, tokens, window, route,
                            embeds)
    x = L.rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x), new


def verify_step(params: dict, cfg, state: dict, tokens: torch.Tensor,
                window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Speculative verification: the (B, K+1) candidate chunk ``[t0, d1..
    dK]`` (the last emitted token, then the drafter's K proposals) in one
    ``route="prefill"`` pass, returning the logits of EVERY position (B,
    K+1, V_pad) f32: ``logits[:, i]`` is the distribution draft ``d_{i+1}``
    is judged against, ``logits[:, K]`` the bonus token's.

    Position i of the chunk gets the bits of a one-query prefill at
    ``pos + i`` over the same prefix: the prefill attend's causal limits
    and tiles sit at absolute positions, and the norms and products are
    row-independent (``layers``). The returned state has advanced ``pos``
    by K+1 and written K/V for every candidate; the caller rolls ``pos``
    back to the accepted length, and the stale K/V past it stays masked
    until a later write replaces it."""
    x, new = _cached_layers(params, cfg, state, tokens, window, "prefill")
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x), new


def _cached_layers(params: dict, cfg, state: dict, tokens: torch.Tensor,
                   window: Optional[int], route: Optional[str],
                   embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, dict]:
    """The layers of ``decode_step`` / ``verify_step``: hidden states (B,
    n + S_new, d) before the final norm (n the ``embeds`` prepended, if
    any), and the advanced state (the KV caches written in place, new
    recurrent states)."""
    x = embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    cur: Union[int, torch.Tensor] = state["pos"]
    pages = state.get("pages")
    steps = torch.arange(s, device=x.device)
    positions = (cur[:, None] + steps[None, :] if isinstance(cur, torch.Tensor)
                 else (cur + steps)[None, :].expand(b, s))
    caches = list(state["caches"])
    n = min(len(cfg.pattern), len(params["blocks"]), len(caches))
    del caches[n:]
    for i in layer_order(cfg, n, x):
        kind, p, cache = cfg.pattern[i], params["blocks"][i], caches[i]
        h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
        if kind == "attn":
            x = x + A.attention_forward(p["attn"], cfg, h, positions, cache,
                                        cur, window, route, pages)
        else:
            out, cache = _recurrent(kind)(p[kind], cfg, h, cache)
            x = x + out
        caches[i] = cache
        if kind not in XLSTM_KINDS:
            x = x + ffn(p, cfg, L.rmsnorm(x, p["norm2"], cfg.norm_eps), True)
    return x, {"caches": caches, "pos": cur + s}
