"""Train-route steps over the LM: the AdamW train step (with gradient
accumulation over microbatches) and the next-token accuracy evaluation of
the HQP conditional prune."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.core.sensitivity import value_and_grad
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def make_train_step(cfg, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch)`` -> (new params, new state,
    ``{"loss": 0-d f32 tensor}``): the gradient of ``lm.loss_fn`` by
    autograd, then ``adamw_update``. With ``num_microbatches`` > 1 the batch
    is cut into that many equal microbatches along axis 0; their gradients
    are summed in f32 and divided by the count, as is their loss.

    An MoE, hybrid or xLSTM config is refused: the JAX package trains MoE
    with the capacity factor's drops and the load-balance and router-z
    losses, none of which is ported, and training without them would be
    another training; the hybrid family (jamba) has MoE layers, and its
    training is that same slice; training the xLSTM family is a slice of
    its own (its loss's gradient runs today only in the HQP Fisher
    pass)."""
    if (cfg.moe is not None and cfg.moe.n_experts) or lm.is_recurrent(cfg):
        raise NotImplementedError(
            f"{cfg.name}: MoE training (capacity-factor drops, load-balance "
            f"and router-z auxiliary losses), hybrid training (jamba's "
            f"MoE and Mamba layers) and xLSTM training (mLSTM and sLSTM "
            f"blocks) are not ported yet; the port compresses and serves "
            f"MoE, hybrid and xLSTM models but trains dense ones only")
    grad_fn = value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b))

    def train_step(params, opt_state, batch):
        n = num_microbatches
        if n == 1:
            loss, grads = grad_fn(params, batch)
        else:
            rows = batch["tokens"].shape[0]
            if rows % n:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{n} microbatches")
            mbs = {k: t.reshape(n, rows // n, *t.shape[1:])
                   for k, t in batch.items()}
            grads = tree.map_(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(n):
                lv, g = grad_fn(params, {k: t[i] for k, t in mbs.items()})
                grads = tree.map_(torch.add, grads, g)
                loss = loss + lv
            grads = tree.map_(lambda g: g / n, grads)
            loss = loss / n
        new_params, new_opt = adamw_update(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {"loss": loss}

    return train_step


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
