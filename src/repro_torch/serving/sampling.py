"""Token selection for the serving stack: greedy argmax (the only mode
ported so far; seeded sampling is ROADMAP A9)."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...,) int32 argmax. Ties go to the lowest index,
    as ``np.argmax`` and ``jnp.argmax`` break them."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
