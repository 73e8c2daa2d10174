"""The next-token accuracy evaluation of the HQP conditional prune.

The JAX package's ``make_train_step`` (AdamW, microbatches) is not ported:
nothing in the compression path trains."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import lm


def make_eval_step(cfg) -> Callable:
    """``eval_step(params, batch)`` -> next-token top-1 accuracy over
    ``batch["tokens"]`` (B, S), a 0-d f32 tensor on the params' device (the
    Δ accuracy metric of the LM track)."""
    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        hidden = lm.forward(params, cfg, batch)
        logits = lm.logits_fn(params, cfg, hidden[:, :tokens.shape[1] - 1],
                              batch_invariant=False)
        pred = logits.argmax(-1)
        return (pred == tokens[:, 1:]).float().mean()

    return eval_step
