"""Deterministic synthetic data: images for the paper's CNNs and a token
corpus for the LM, copies of the JAX package's in numpy alone, so the same
seeds give the same arrays and batch orders, bit for bit.

Images: class templates, structured shifts and noise, learnable to ~95 % by
the small CNNs in a few hundred steps, and degrading smoothly under channel
masking, which is what Algorithm 1 needs to meet its accept/reject boundary.

Tokens: sparse order-1 Markov chains. The LM learns the transition table;
next-token top-1 accuracy (bounded by the chain's determinism) is the
validation metric the Δ_ax constraint is enforced against.

The reference draws the chain and the sequences from one ``seed``, so two
corpora with two seeds are two different chains: its quickstart's
validation corpus (seed 9) is not the task it trained on (seed 0), and its
accuracy sits near 1/vocab. ``chain_seed`` (not in the reference) draws the
chain from its own seed, the sequences from ``seed``; ``chain_seed=0`` gives
seed 0's chain, so a validation split of the training task is
``SyntheticTokens(..., seed=9, chain_seed=0)``."""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class SyntheticImages:
    def __init__(self, n: int, n_classes: int = 10, image_size: int = 32,
                 seed: int = 0, noise: float = 0.35, template_seed: int = 0):
        # class templates are shared across splits (template_seed), only the
        # sampling differs per split (seed): train/val/calib measure the
        # SAME task
        trng = np.random.RandomState(template_seed)
        rng = np.random.RandomState(seed + 1)
        k = image_size
        self.templates = trng.randn(n_classes, k, k, 3).astype(np.float32)
        for c in range(n_classes):
            # low-pass: keep the templates smooth so conv features matter
            t = self.templates[c]
            t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1)
                 + np.roll(t, 2, 0) + np.roll(t, 2, 1)) / 5.0
            self.templates[c] = t / (np.abs(t).max() + 1e-6)
        self.labels = rng.randint(0, n_classes, size=n).astype(np.int32)
        shift = rng.randint(-3, 4, size=(n, 2))
        imgs = np.empty((n, k, k, 3), np.float32)
        for i in range(n):
            t = self.templates[self.labels[i]]
            t = np.roll(t, tuple(shift[i]), axis=(0, 1))
            imgs[i] = t + noise * rng.randn(k, k, 3)
        self.images = imgs.astype(np.float32)

    def __len__(self):
        return len(self.labels)

    def batches(self, batch_size: int, seed: Optional[int] = None,
                epochs: int = 1) -> Iterator[dict]:
        """``{"image": (batch_size, k, k, 3) f32 NHWC, "label":
        (batch_size,) int32}`` batches, shuffled by ``seed`` each epoch (in
        order without one); a last partial batch is dropped."""
        n = len(self)
        idx = np.arange(n)
        rng = np.random.RandomState(seed) if seed is not None else None
        for _ in range(epochs):
            if rng is not None:
                rng.shuffle(idx)
            for i in range(0, n - batch_size + 1, batch_size):
                sel = idx[i:i + batch_size]
                yield {"image": self.images[sel], "label": self.labels[sel]}


class SyntheticTokens:
    def __init__(self, vocab: int, seq_len: int, n_seqs: int,
                 seed: int = 0, branching: int = 4, determinism: float = 0.85,
                 chain_seed: Optional[int] = None):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        # sparse markov transition: each token has `branching` successors,
        # one dominant with prob `determinism`
        chain_rng = (rng if chain_seed is None
                     else np.random.RandomState(chain_seed))
        succ = chain_rng.randint(0, vocab, size=(vocab, branching))
        probs = np.full((vocab, branching),
                        (1 - determinism) / max(branching - 1, 1))
        probs[:, 0] = determinism
        seqs = np.empty((n_seqs, seq_len), np.int64)
        state = rng.randint(0, vocab, size=n_seqs)
        for t in range(seq_len):
            seqs[:, t] = state
            # vectorized successor draw
            u = rng.rand(n_seqs)
            pick = np.where(u < determinism, 0,
                            rng.randint(1, branching, size=n_seqs))
            state = succ[state, pick]
        self.seqs = seqs.astype(np.int32)
        self.best_acc = determinism  # ceiling for next-token accuracy
        self.succ = succ             # (vocab, branching); column 0 dominant

    def batches(self, batch_size: int, seed: Optional[int] = None,
                epochs: int = 1) -> Iterator[dict]:
        """``{"tokens": (batch_size, seq_len) int32}`` batches, shuffled by
        ``seed`` each epoch (in order without one); a last partial batch is
        dropped."""
        n = len(self.seqs)
        idx = np.arange(n)
        rng = np.random.RandomState(seed) if seed is not None else None
        for _ in range(epochs):
            if rng is not None:
                rng.shuffle(idx)
            for i in range(0, n - batch_size + 1, batch_size):
                yield {"tokens": self.seqs[idx[i:i + batch_size]]}
