"""Activation and weight range calibration: absmax, percentile and
KL-divergence, the JAX package's numpy code as it is, so the same histogram
gives the same threshold bit for bit.

The KL method is the TensorRT entropy calibration the paper relies on
(§IV-B "TensorRT performs the KL-Divergence calibration on D_calib"):
histogram |x| into fine bins, then for each candidate clip threshold T build
P (clipped reference distribution, tail mass folded into the last bin) and Q
(P re-quantized to 2^{b-1}-1 levels and re-expanded), and pick the T
minimizing KL(P||Q).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

N_BINS = 2048


# ------------------------------------------------------------------ methods
def absmax_scale(amax: float, bits: int = 8) -> float:
    return max(amax, 1e-8) / (2 ** (bits - 1) - 1)


def percentile_threshold(hist: np.ndarray, edges: np.ndarray,
                         pct: float = 99.99) -> float:
    cdf = np.cumsum(hist) / max(hist.sum(), 1)
    idx = int(np.searchsorted(cdf, pct / 100.0))
    return float(edges[min(idx + 1, len(edges) - 1)])


def _kl_div(p: np.ndarray, q: np.ndarray) -> float:
    mask = p > 0
    qm = np.where(q > 0, q, 1e-12)
    return float(np.sum(p[mask] * np.log(p[mask] / qm[mask])))


def _requantized(h: np.ndarray, n_levels: int) -> np.ndarray:
    """``h`` cut into ``np.array_split(h, n_levels)``'s chunks, each
    nonzero bin given its chunk's sum over its nonzero bins: the JAX
    package's loop over the chunks, a row of a 2-D view per chunk. The
    first ``len(h) % n_levels`` chunks are one bin longer, so two views
    cover them; a row's sum is the chunk's ``sum()``, bit for bit."""
    base, extra = divmod(h.size, n_levels)
    cut = extra * (base + 1)
    q = np.zeros(h.size)
    for lo, hi, width in ((0, cut, base + 1), (cut, h.size, base)):
        if hi == lo:
            continue
        rows = h[lo:hi].reshape(-1, width)
        pos = rows > 0
        nz = pos.sum(axis=1)
        mean = np.divide(rows.sum(axis=1), nz, out=np.zeros(len(rows)),
                         where=nz > 0)
        q[lo:hi] = np.where(pos, mean[:, None], 0.0).ravel()
    return q


def kl_threshold(hist: np.ndarray, edges: np.ndarray, bits: int = 8) -> float:
    """TensorRT-style entropy calibration over an |x| histogram.

    Two guards against the ReLU-spike failure mode (a dominant zero bin makes
    KL favor near-total clipping): the zero bin is excluded from the
    divergence (TRT does the same), and the returned threshold is floored at
    the 99th-percentile threshold — KL may only *refine* within the top
    percentile, never clip below it."""
    n_levels = 2 ** (bits - 1) - 1                       # 127 for int8
    hist = hist.astype(np.float64).copy()
    hist[0] = 0.0                                        # exclude zero spike
    floor_t = percentile_threshold(hist, edges, 99.0)
    best_kl, best_i = np.inf, N_BINS
    start = max(n_levels, N_BINS // 16)
    for i in range(start, N_BINS + 1, 8):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()                       # fold clipped tail
        if p.sum() == 0:
            continue
        # quantize the first i bins down to n_levels and expand back
        q = _requantized(hist[:i], n_levels)
        p /= p.sum()
        qs = q.sum()
        if qs == 0:
            continue
        q /= qs
        kl = _kl_div(p, q)
        if kl < best_kl:
            best_kl, best_i = kl, i
    return max(float(edges[best_i]), floor_t)


# ------------------------------------------------------------------ collector
@dataclasses.dataclass
class TensorStats:
    amax: float = 0.0
    hist: Optional[np.ndarray] = None
    edges: Optional[np.ndarray] = None

    def update_amax(self, x: np.ndarray):
        self.amax = max(self.amax, float(np.max(np.abs(x))))

    def update_hist(self, x: np.ndarray):
        if self.hist is None:
            self.edges = np.linspace(0.0, max(self.amax, 1e-8), N_BINS + 1)
            self.hist = np.zeros(N_BINS)
        h, _ = np.histogram(np.abs(x), bins=self.edges)
        self.hist += h

    def scale(self, method: str = "kl", bits: int = 8) -> float:
        if method == "absmax" or self.hist is None:
            return absmax_scale(self.amax, bits)
        if method == "percentile":
            t = percentile_threshold(self.hist, self.edges)
        elif method == "kl":
            t = kl_threshold(self.hist, self.edges, bits)
        else:
            raise ValueError(method)
        return absmax_scale(t, bits)


class ActQ:
    """Activation-quantization tap threaded through the models' apply
    functions.

    mode="amax"  : pass 1 — record per-site absmax (copies x to the host).
    mode="hist"  : pass 2 — accumulate |x| histograms (copies x to the host).
    mode="apply" : fake-quantize with the calibrated static scales, on x's
                   device, with no host sync (CUDA-graph safe).
    mode=None    : no-op.

    An empty activation (a family pruned to no channel) passes through
    untouched in every mode: it has no range to record or quantize.
    """

    def __init__(self, mode: Optional[str] = None, bits: int = 8,
                 method: str = "kl"):
        self.mode = mode
        self.bits = bits
        self.method = method
        self.stats: Dict[str, TensorStats] = {}
        self.scales: Dict[str, float] = {}

    def tap(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.mode is None or x.numel() == 0:
            return x
        if self.mode == "amax":
            self.stats.setdefault(name, TensorStats()).update_amax(_host(x))
            return x
        if self.mode == "hist":
            self.stats[name].update_hist(_host(x))
            return x
        if self.mode == "apply":
            s = self.scales[name]
            qmax = 2 ** (self.bits - 1) - 1
            return (torch.clamp(torch.round(x / s), -qmax, qmax)
                    * s).to(x.dtype)
        raise ValueError(self.mode)

    def finalize(self):
        self.scales = {k: st.scale(self.method, self.bits)
                       for k, st in self.stats.items()}
        self.mode = "apply"
        return self


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
