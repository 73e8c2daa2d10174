"""The parts of ``jax.random`` that token sampling uses, in torch: the
threefry2x32 hash, ``PRNGKey``, ``fold_in``, random bits in the
partitionable layout, ``uniform``, ``gumbel`` and ``categorical``. Given
the same keys they give the bits, uniforms and draws of ``jax.random``
with ``jax_threefry_partitionable`` on (its default), so a seeded sampler
here draws what the JAX package's draws on the same logits.

A key is an int64 tensor (..., 2) holding the two uint32 words of a JAX
key. Every function is elementwise over the leading axes: a (B, 2) key
tensor is B independent keys, and ``fold_in`` takes a (B,) tensor of data
words, so a batch of positions becomes a batch of keys in one call. The
words stay in int64 masked to 32 bits, where add, xor and shifts are
exact on every device.

Everything runs on the tensors' device with no host sync, no
``torch.Generator`` and no global RNG state: a CUDA graph that replays a
draw replays the same draw, and the draw depends on its key alone, never
on how many draws came before."""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# smallest normal f32: the lower bound gumbel's uniforms start from
F32_TINY = float(np.finfo(np.float32).tiny)

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word):
    """Threefry-2x32 with 20 rounds over uint32 words held in int64 (or
    Python ints); arguments broadcast. Returns the two output words, as
    ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX makes it in its default 32-bit
    mode, the mode the JAX package runs in: the seed becomes an int32
    (a 64-bit seed keeps its low word), whose high word is 0. Made on the
    host: build it outside any CUDA-graph capture."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: Word) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or an integer
    tensor broadcasting against the key's leading axes, taken as uint32.
    Returns the folded keys (..., 2)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, data & MASK)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key: (..., *shape)
    int64. The partitionable layout: element n hashes the counter words
    (n >> 32, n & 0xFFFFFFFF) of the row-major index n, and its bits are
    the xor of the two output words."""
    shape = tuple(shape)
    n = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                     device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0].reshape(lead),
                          key[..., 1].reshape(lead), n >> 32, n & MASK)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval) and floored at
    ``minval``."""
    bits = random_bits(key, shape)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * span + float(np.float32(minval)),
                           float(np.float32(minval)))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in f32: -log(-log(u)), u uniform
    on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: argmax of gumbel noise
    plus the logits (f32), the first index on ties. key (..., 2) against
    logits (..., V); returns (...,) int64."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
