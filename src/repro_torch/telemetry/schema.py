"""Declared metric schema: the single enumeration of every stats key.

The engine and service ``stats`` stay plain dicts of plain Python numbers
(``for k in eng.stats:``, ``dict(svc.stats)``, delta arithmetic and
``**eng.stats`` splats keep working, and reading them touches no device),
but every key they may carry is declared here with a metric kind and a
help string. The Prometheus exposition (``metrics.MetricsRegistry``) and
``GET /metrics`` read this enumeration: a stats key that is not declared
makes ``register_stats`` raise.

The buckets, phase names, span names and family names are the JAX
package's (``repro.telemetry.schema``) letter for letter, so a scrape of
either server parses with either package's parser. ``ENGINE_STATS``
adds the keys only the port's engine writes (``PORT_ENGINE_STATS``:
speculative cycles, the KV arena's size and the CUDA-graph counters of
``serving.dispatch``).
"""
from __future__ import annotations

import math


# ------------------------------------------------------------- buckets
def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple:
    """Fixed log-spaced histogram bucket edges from lo to hi inclusive."""
    if not (lo > 0 and hi > lo and per_decade > 0):
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    n = int(round((math.log10(hi) - math.log10(lo)) * per_decade))
    return tuple(round(10.0 ** (math.log10(lo) + i / per_decade), 12)
                 for i in range(n + 1))


# per-step phase times: sub-microsecond Python overhead up to multi-second
# faulted steps; request latencies: 1 ms to 100 s covers smoke -> overload
PHASE_BUCKETS_S = log_buckets(1e-6, 10.0, per_decade=4)
LATENCY_BUCKETS_S = log_buckets(1e-3, 100.0, per_decade=4)

# ------------------------------------------------- stats declarations
# kind: "counter" = monotone within a run (benches zero them between
# passes — that is a restart, same as a process restart in Prometheus
# terms); "gauge" = point-in-time or high-water value.
REFERENCE_ENGINE_STATS = {
    "prefill_ticks": ("counter", "scheduler ticks that dispatched a prefill chunk"),
    "decode_ticks": ("counter", "scheduler ticks that dispatched a batched decode scan"),
    "decode_slot_steps": ("counter", "slot-steps that emitted a token across decode scans"),
    "prefill_tokens": ("counter", "prompt tokens consumed by prefill chunks"),
    "host_syncs": ("counter", "host synchronisation points (one per scan/chunk tail)"),
    "device_steps": ("counter", "device-side model steps (scan length x dispatches)"),
    "drafted_tokens": ("counter", "tokens drafted (speculative) or scanned (plain decode)"),
    "accepted_tokens": ("counter", "tokens accepted/emitted to requests"),
    "prefix_hits": ("counter", "prompts that reused a cached shared prefix"),
    "prefix_hit_tokens": ("counter", "prompt tokens served from the prefix cache"),
    "bytes_saved": ("counter", "KV bytes not written thanks to prefix reuse"),
    "cow_copies": ("counter", "copy-on-write page copies"),
    "pages_in_use": ("gauge", "KV pages currently allocated"),
    "pages_peak": ("gauge", "high-water mark of allocated KV pages"),
    "cancelled": ("counter", "requests cancelled (client or deadline)"),
    "faults": ("counter", "faults absorbed by the engine fault boundary"),
    "kv_bytes_peak": ("gauge", "high-water mark of KV arena bytes"),
}

# kv_bytes is the pools' fixed size, a gauge; graph_pool_bytes is the
# device memory the graphs' shared pool reserved, which only grows
PORT_ENGINE_STATS = {
    "spec_cycles": ("counter", "speculative draft -> verify cycles"),
    "kv_bytes": ("gauge", "bytes of the KV pools (both pools when speculative)"),
    "graphs_captured": ("counter", "CUDA graphs captured (one per dispatch key)"),
    "graph_replays": ("counter", "dispatches run as a CUDA graph replay"),
    "eager_dispatches": ("counter", "dispatches run eagerly (a key's first use, or on the CPU)"),
    "capture_s": ("counter", "seconds spent capturing CUDA graphs"),
    "graph_pool_bytes": ("gauge", "device bytes the CUDA graphs' memory pool reserved"),
}

ENGINE_STATS = {**REFERENCE_ENGINE_STATS, **PORT_ENGINE_STATS}

SERVICE_STATS = {
    "submitted": ("counter", "requests accepted into the service"),
    "completed": ("counter", "requests finished with a token-bearing result"),
    "shed": ("counter", "requests rejected at admission (queue full or infeasible)"),
    "shed_infeasible": ("counter", "sheds attributed to the feasibility predictor"),
    "expired": ("counter", "admitted requests evicted at their deadline"),
    "cancelled": ("counter", "requests cancelled by the client"),
    "faults": ("counter", "engine faults observed by the service boundary"),
    "queue_peak": ("gauge", "high-water mark of the waiting queue"),
}

# every stats key any serving module may write
DECLARED_STAT_KEYS = frozenset(ENGINE_STATS) | frozenset(SERVICE_STATS)

ENGINE_PREFIX = "repro_engine_"
SERVICE_PREFIX = "repro_service_"

# ------------------------------------------------- span phase names
# per-step wall-time attribution (engine.last_step["phases"]) and the
# histogram label values under repro_step_phase_seconds{phase=...}
PHASES = ("admit", "prefill_dispatch", "decode_scan", "host_sync",
          "token_fanout", "total")

# span names the recorder may emit per request track
SPAN_NAMES = ("request", "queued", "active", "prefill", "decode", "spec")
INSTANT_NAMES = ("first_token", "finish", "shed")
TERMINAL_REASONS = ("length", "eos", "error", "cancelled", "shed")

PHASE_HISTOGRAM = "repro_step_phase_seconds"
TTFT_HISTOGRAM = "repro_request_ttft_seconds"
LATENCY_HISTOGRAM = "repro_request_latency_seconds"


def metric_names() -> list:
    """Every family name the default registry exposes (smoke checks)."""
    names = [ENGINE_PREFIX + k for k in ENGINE_STATS]
    names += [SERVICE_PREFIX + k for k in SERVICE_STATS]
    names += [PHASE_HISTOGRAM, TTFT_HISTOGRAM, LATENCY_HISTOGRAM]
    return names
