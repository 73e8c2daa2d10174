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


def make_train_step(cfg, opt_cfg: AdamWConfig, num_microbatches: int = 1,
                    moe_no_drop: bool = True) -> Callable:
    """``train_step(params, opt_state, batch)`` -> (new params, new state,
    metrics): the gradient of ``lm.loss_fn(with_aux=True)`` by autograd,
    then ``adamw_update``. ``metrics`` holds ``"loss"`` (0-d f32, the
    auxiliary losses included) and, for a config with MoE layers,
    ``"aux/load_balance"`` and ``"aux/router_z"``, as the JAX package's.
    ``moe_no_drop`` is its ``ctx.moe_no_drop``, True by default as there
    (the experts at inference capacity); the launcher trains with False,
    the capacity factor's drops. With ``num_microbatches`` > 1 the batch is
    cut into that many equal microbatches along axis 0; their gradients
    are summed in f32 and divided by the count, as is their loss, and the
    aux is the last microbatch's. Every entry of ``batch`` (``tokens``,
    and a frontend's ``embeds``) is cut by rows alike."""
    grad_fn = value_and_grad(
        lambda p, b: lm.loss_fn(p, cfg, b, with_aux=True,
                                moe_no_drop=moe_no_drop),
        has_aux=True)

    def train_step(params, opt_state, batch):
        n = num_microbatches
        if n == 1:
            (loss, aux), grads = grad_fn(params, batch)
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
                (lv, aux), g = grad_fn(params,
                                       {k: t[i] for k, t in mbs.items()})
                grads = tree.map_(torch.add, grads, g)
                loss = loss + lv
            grads = tree.map_(lambda g: g / n, grads)
            loss = loss / n
        new_params, new_opt = adamw_update(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {"loss": loss, **{
            f"aux/{k}": v for k, v in aux.items()}}

    return train_step


def make_eval_step(cfg) -> Callable:
    """``eval_step(params, batch)`` -> next-token top-1 accuracy over
    ``batch["tokens"]`` (B, S), a 0-d f32 tensor on the params' device (the
    Δ accuracy metric of the LM track). A config with a frontend takes
    ``batch["embeds"]`` too, and its positions predict no token."""
    n_fr = cfg.n_frontend

    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        hidden = lm.forward(params, cfg, batch)
        logits = lm.logits_fn(params, cfg,
                              hidden[:, n_fr:n_fr + tokens.shape[1] - 1],
                              batch_invariant=False)
        pred = logits.argmax(-1)
        return (pred == tokens[:, 1:]).float().mean()

    return eval_step
