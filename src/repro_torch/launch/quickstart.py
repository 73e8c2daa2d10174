"""Quickstart: train, then compress once and serve many (the port's
counterpart of the JAX package's ``examples/quickstart.py``).

  1. train qwen3-0.6b (``--smoke``: its reduced config) on a synthetic
     Markov corpus with AdamW,
  2. the diagonal-Fisher sensitivity over 4 calibration batches,
  3. Algorithm 1: conditional pruning in steps of 5 % of the units, each
     judged by next-token accuracy on a held-out set against Δ_ax = 1.5 %,
     one ``[hqp] step`` line each with ACCEPT or REJECT,
  4. compaction and INT8 PTQ of the last accepted model,
  5. save the artifact, load it back, and serve it through the engine with
     an INT8 KV cache: every request must equal serial decode of the loaded
     artifact and of the one in memory.

  python -m repro_torch.launch.quickstart --smoke --device cpu
  python -m repro_torch.launch.quickstart          # full width, on the card
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Callable, List

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.compress.artifact import compress
from repro_torch.core.pipeline import HQPConfig
from repro_torch.core.sensitivity import fisher_diag, loss_grad_fn
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch.checkpoint import load_artifact, save_artifact
from repro_torch.models import lm
from repro_torch.serving import Engine, Request, serial_decode
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_eval_step, make_train_step

# The corpus's token ids lie below DATA_VOCAB whatever the model's vocab (the
# smoke config's is 256 itself): a chain over all of qwen3-0.6b's 151,936
# ids could not be learned from a few hundred steps of 64 x 33 tokens.
DATA_VOCAB = 256
ARCH = "qwen3-0.6b"
SEQ, BATCH, N_TRAIN, N_VAL, DETERMINISM = 33, 64, 2048, 512, 0.9
STEPS, LR = 240, 3e-3
N_CALIB = 4                      # calibration batches of the Fisher pass
HQP = HQPConfig(delta_ax=0.015, step_frac=0.05, max_steps=20)
SERVE_PROMPTS, SERVE_PROMPT_LEN, SERVE_NEW, SERVE_MAX_SEQ = 4, 16, 8, 64


def corpus(cfg):
    """(train, validation) corpora: the reference quickstart's training
    corpus (2,048 sequences of 33 tokens, seed 0), and 512 sequences of the
    same chain sampled with seed 9 (the reference's seed-9 corpus is another
    chain: ``SyntheticTokens``'s docstring)."""
    vocab = min(cfg.vocab_size, DATA_VOCAB)
    return (SyntheticTokens(vocab, SEQ, N_TRAIN, seed=0,
                            determinism=DETERMINISM),
            SyntheticTokens(vocab, SEQ, N_VAL, seed=9, chain_seed=0,
                            determinism=DETERMINISM))


def to_batch(tokens: np.ndarray, device) -> dict:
    return {"tokens": torch.as_tensor(tokens, dtype=torch.long,
                                      device=device)}


def train_batches(data: SyntheticTokens, steps: int, device) -> List[dict]:
    """The first ``steps`` batches of ``BATCH`` rows, reshuffled each epoch
    from seed 0."""
    it = data.batches(BATCH, seed=0, epochs=-(-steps // (N_TRAIN // BATCH)))
    return [to_batch(next(it)["tokens"], device) for _ in range(steps)]


def accuracy_fn(cfg, val: SyntheticTokens, device) -> Callable[[dict], float]:
    """params -> mean next-token accuracy over the validation batches."""
    eval_step = make_eval_step(cfg)
    batches = [to_batch(b["tokens"], device) for b in val.batches(BATCH)]

    def accuracy(params) -> float:
        return float(torch.stack([eval_step(params, b)
                                  for b in batches]).mean())
    return accuracy


def fisher(cfg, params, data: SyntheticTokens, device):
    """The Fisher diagonal over the first N_CALIB training batches, in
    order."""
    calib = [to_batch(b["tokens"], device)
             for b in data.batches(BATCH)][:N_CALIB]
    sq, _ = fisher_diag(loss_grad_fn(lambda p, b: lm.loss_fn(p, cfg, b)),
                        params, calib)
    return sq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="qwen3-0.6b's reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_smoke_config(ARCH) if args.smoke
           else configs.get_config(ARCH))
    print(f"== HQP quickstart on {cfg.name} ({device}) ==")
    t0 = time.time()

    # ---- 1. train ----
    data, val = corpus(cfg)
    params = lm.init_params(cfg, seed=0, device=device)
    opt_cfg = AdamWConfig(lr=LR)
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    for step, batch in enumerate(train_batches(data, args.steps, device)):
        params, opt, m = step_fn(params, opt, batch)
        if step % 60 == 0:
            print(f"  step {step:4d} loss={float(m['loss']):.3f}")
    del opt
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")

    # ---- 2. Fisher, 3. Algorithm 1, 4. compaction + INT8 PTQ ----
    accuracy = accuracy_fn(cfg, val, device)
    sq = fisher(cfg, params, data, device)
    art = compress(params, cfg, sq_grads=sq, eval_fn=accuracy, hqp=HQP)
    del sq
    m = art.manifest
    print(f"baseline next-token accuracy: {m.a_baseline:.3f} "
          f"(chain ceiling {data.best_acc})")
    print(f"pruned θ={m.theta:.0%} (acc {m.a_final:.3f}, drop "
          f"{m.a_baseline - m.a_final:+.4f} <= {HQP.delta_ax})")
    a_hqp = accuracy(art.params)
    print(f"HQP (prune+INT8): acc={a_hqp:.3f} "
          f"drop={m.a_baseline - a_hqp:+.4f} size {m.bytes_before / 1e6:.1f}MB -> {m.bytes_after / 1e6:.1f}MB")

    # ---- 5. compress once, serve many ----
    with tempfile.TemporaryDirectory() as tmp:
        path = save_artifact(f"{tmp}/artifact", art)
        loaded = load_artifact(path, device=device)
    print(f"artifact saved to {path} and loaded back")
    prompts = val.seqs[:SERVE_PROMPTS, :SERVE_PROMPT_LEN].tolist()
    eng = Engine(loaded.params, cfg, n_slots=SERVE_PROMPTS,
                 max_seq=SERVE_MAX_SEQ, quantized_kv=True, device=device)
    results = eng.run([Request(prompt=p, max_new_tokens=SERVE_NEW)
                       for p in prompts])
    for i, p in enumerate(prompts):
        for which, params_i in (("loaded", loaded.params),
                                ("in-memory", art.params)):
            want = serial_decode(params_i, cfg, p, SERVE_NEW,
                                 max_seq=SERVE_MAX_SEQ, quantized_kv=True,
                                 device=device)
            if results[i].tokens != want:
                raise SystemExit(f"request {i}: the engine on the loaded "
                                 f"artifact gave {results[i].tokens}, serial "
                                 f"decode of the {which} artifact {want}")
    print("engine == serial decode of the loaded and of the in-memory "
          "artifact on every request")
    print("decoded continuation:",
          [results[i].tokens for i in range(len(prompts))])
    print(f"== done in {time.time() - t0:.1f}s ==")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
