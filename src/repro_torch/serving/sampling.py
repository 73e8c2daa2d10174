"""Token sampling for the serving stack: greedy, temperature, top-k.

One ``SamplingConfig`` drives every decode surface (the engine's prefill
tails and decode dispatches, ``serial_decode``, the launcher's lockstep
loop and the speculative drafter), so a seed gives the same tokens on
each.

The token emitted at absolute position ``p`` (the position its KV is
written at) is drawn with ``token_key(base_key(cfg), p)``: the key
depends on (seed, lane, position) only, never on the slot, the tick or
which requests share a dispatch, so the engine's batched draws equal
serial decode's. Two requests with the same prompt and seed therefore
draw the same tokens; callers wanting diverse samples vary the seed.
Speculative decoding draws its acceptance uniforms and its residual
resamples on lanes of their own. The keys are threefry (``prng``), so a
draw equals the JAX package's ``jax.random`` draw on the same logits.

``temperature == 0`` is greedy: callers branch on
``SamplingConfig.is_greedy`` and take ``greedy``, a key-free argmax."""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.kernels.ref import ieee_div
from repro_torch.serving import prng

# key lanes: ordinary next-token draws (engine, serial, drafts), the
# speculative acceptance uniforms, the speculative residual resamples
LANE_TOKEN, LANE_ACCEPT, LANE_RESIDUAL = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``temperature=0`` is greedy (no keys); ``top_k=0`` keeps the whole
    vocabulary."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingConfig()


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...,) int32 argmax. Ties go to the lowest index,
    as ``np.argmax`` and ``jnp.argmax`` break them."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def base_key(cfg: SamplingConfig, device=None) -> torch.Tensor:
    """The seed's key (2,), made on the host: a caller that captures a
    CUDA graph makes it first, and the graph reads it as a fixed buffer."""
    return prng.prng_key(cfg.seed, device)


def token_key(base: torch.Tensor, pos: Union[int, torch.Tensor],
              lane: int = LANE_TOKEN) -> torch.Tensor:
    """Keys (..., 2) for tokens at absolute positions ``pos`` (an int or
    an integer tensor of any shape)."""
    return prng.fold_in(prng.fold_in(base, lane), pos)


def warp_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Top-k mask, then temperature, on the last axis in f32. Every logit
    ``>=`` the k-th largest is kept, so ties at the boundary all stay;
    the rest go to -inf and get probability 0."""
    lg = logits.float()
    if 0 < cfg.top_k < lg.shape[-1]:
        kth = torch.topk(lg, cfg.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg >= kth, lg, float("-inf"))
    if not cfg.is_greedy:
        lg = ieee_div(lg, cfg.temperature)
    return lg


def probs(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """The f32 distribution a draw follows after ``warp_logits``: the p and
    q that speculative acceptance compares."""
    return torch.softmax(warp_logits(logits, cfg), dim=-1)


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           key: torch.Tensor) -> torch.Tensor:
    """Tokens (...,) int64 from logits (..., V) with keys (..., 2);
    greedy ignores the keys."""
    if cfg.is_greedy:
        return torch.argmax(logits, dim=-1)
    return prng.categorical(key, warp_logits(logits, cfg))


def sample_batch(logits: torch.Tensor, cfg: SamplingConfig,
                 base: torch.Tensor, pos: torch.Tensor,
                 lane: int = LANE_TOKEN) -> torch.Tensor:
    """One token per row: logits (B, V), ``pos`` (B,) absolute positions;
    each row draws with its own position's key, whatever else shares the
    batch. Returns (B,) int64."""
    if cfg.is_greedy:
        return torch.argmax(logits, dim=-1)
    return sample(logits, cfg, token_key(base, pos, lane))
