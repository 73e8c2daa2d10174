"""Zero-dependency metrics registry with Prometheus text exposition.

Three metric kinds: ``Counter`` and ``Gauge`` (a float cell), and
``Histogram`` (fixed log-spaced buckets, Prometheus ``le`` semantics:
an observation lands in the first bucket whose upper edge is >= the
value; values above the last edge land in the implicit +Inf overflow
bucket). Histograms merge bucket-wise, which is how bench passes and
per-phase shards combine.

The registry also *adopts* existing plain-dict stats surfaces
(``register_stats``): the dict stays the writable source of truth —
engine/service code keeps doing ``stats["k"] += 1`` and benches keep
doing ``for k in stats: stats[k] = 0`` — and the registry reads the
live values only at render time. That keeps the hot-path cost of the
migration at exactly zero while ``GET /metrics`` covers every key.

Rendering follows the Prometheus text format v0.0.4 (HELP/TYPE per
family, cumulative ``_bucket`` series with escaped label values,
``_sum``/``_count``). ``parse_exposition`` is the matching reader used
by the round-trip tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import re
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from . import schema

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "escape_label", "parse_exposition"]


def escape_label(value: str) -> str:
    """Escape a label value per the exposition format."""
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return str(int(v))
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_text(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


@dataclass
class Counter:
    name: str
    help: str
    labels: Dict[str, str] = field(default_factory=dict)
    value: float = 0.0
    kind: str = "counter"

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self.value += n

    def set(self, v: float) -> None:
        # benches reset stats between passes; a reset is a restart
        self.value = float(v)


@dataclass
class Gauge:
    name: str
    help: str
    labels: Dict[str, str] = field(default_factory=dict)
    value: float = 0.0
    kind: str = "gauge"

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram; ``le`` edges are inclusive upper bounds."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None,
                 labels: Optional[Mapping[str, str]] = None):
        edges = tuple(buckets if buckets is not None
                      else schema.LATENCY_BUCKETS_S)
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"histogram {name}: edges must be strictly "
                             f"increasing, got {edges}")
        self.name, self.help = name, help
        self.labels = dict(labels or {})
        self.edges = edges
        # counts[i] observations in (edges[i-1], edges[i]]; counts[-1]
        # is the +Inf overflow bucket
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def merge(self, other: "Histogram") -> None:
        if other.edges != self.edges:
            raise ValueError(f"histogram {self.name}: cannot merge "
                             f"mismatched edges")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def to_dict(self) -> dict:
        """JSON-friendly form for result payloads (non-cumulative counts;
        counts[-1] is the overflow bucket)."""
        return {"le": list(self.edges), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    @classmethod
    def from_dict(cls, d: Mapping, name: str = "hist") -> "Histogram":
        h = cls(name, buckets=d["le"])
        counts = list(d["counts"])
        if len(counts) != len(h.counts):
            raise ValueError(f"histogram {name}: {len(counts)} counts for "
                             f"{len(h.edges)} edges")
        h.counts = counts
        h.sum = float(d.get("sum", 0.0))
        h.count = int(d.get("count", sum(counts)))
        return h

    def quantile(self, q: float) -> float:
        """Bucket-upper-edge quantile (what a Prometheus consumer sees)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        running = 0
        for i, c in enumerate(self.counts):
            running += c
            if running >= target and c:
                return (self.edges[i] if i < len(self.edges)
                        else self.edges[-1])
        return self.edges[-1]


class MetricsRegistry:
    """Holds metric objects plus adopted stats dicts; renders exposition."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        # (prefix, live dict, {key: (kind, help)})
        self._stats_views: List[Tuple[str, Mapping, Mapping]] = []

    # ------------------------------------------------------ creation
    def _add(self, metric):
        key = (metric.name, tuple(sorted(metric.labels.items())))
        if key in self._metrics:
            raise ValueError(f"duplicate metric {key}")
        self._metrics[key] = metric
        return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._add(Counter(name, help, labels))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._add(Gauge(name, help, labels))

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._add(Histogram(name, help, buckets, labels))

    def register_stats(self, prefix: str, stats: Mapping,
                       declared: Mapping) -> None:
        """Adopt a live stats dict: every present key must be declared
        (kind + help), values are read at render time."""
        undeclared = set(stats) - set(declared)
        if undeclared:
            raise ValueError(f"stats keys {sorted(undeclared)} not in the "
                             f"telemetry schema for prefix {prefix!r}")
        self._stats_views.append((prefix, stats, declared))

    # ----------------------------------------------------- rendering
    def _families(self):
        fams: Dict[str, List] = {}
        helps: Dict[str, Tuple[str, str]] = {}
        for prefix, stats, declared in self._stats_views:
            for key in stats:
                kind, help_ = declared[key]
                name = prefix + key
                helps.setdefault(name, (kind, help_))
                fams.setdefault(name, []).append(
                    Gauge(name, help_, {}, float(stats[key]), kind=kind))
        for metric in self._metrics.values():
            helps.setdefault(metric.name, (metric.kind, metric.help))
            fams.setdefault(metric.name, []).append(metric)
        return fams, helps

    def render(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        out: List[str] = []
        fams, helps = self._families()
        for name in sorted(fams):
            kind, help_ = helps[name]
            out.append(f"# HELP {name} {help_}" if help_
                       else f"# HELP {name} (no help)")
            out.append(f"# TYPE {name} {kind}")
            for m in fams[name]:
                if kind == "histogram":
                    cum = 0
                    for i, edge in enumerate(m.edges):
                        cum += m.counts[i]
                        lbl = dict(m.labels, le=_fmt(edge))
                        out.append(f"{name}_bucket{_labels_text(lbl)} {cum}")
                    cum += m.counts[-1]
                    lbl = dict(m.labels, le="+Inf")
                    out.append(f"{name}_bucket{_labels_text(lbl)} {cum}")
                    out.append(f"{name}_sum{_labels_text(m.labels)} "
                               f"{_fmt(m.sum)}")
                    out.append(f"{name}_count{_labels_text(m.labels)} "
                               f"{m.count}")
                else:
                    out.append(f"{name}{_labels_text(m.labels)} "
                               f"{_fmt(m.value)}")
        return "\n".join(out) + "\n"


# ------------------------------------------------------------- parser
_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return re.sub(r'\\(.)',
                  lambda m: {"n": "\n", '"': '"', "\\": "\\"}.get(
                      m.group(1), "\\" + m.group(1)), value)


def parse_exposition(text: str) -> dict:
    """Parse exposition text into {"types": {family: kind},
    "samples": {(name, ((label, value), ...)): float}}. Raises
    ValueError on a line that is neither comment, blank, nor sample —
    the round-trip tests and ``chip_smoke.py`` both lean on that strictness.
    """
    types: Dict[str, str] = {}
    samples: Dict[Tuple[str, Tuple], float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            fam, _, kind = rest.partition(" ")
            types[fam] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: not a valid sample: {line!r}")
        labels = []
        if m.group("labels"):
            consumed = 0
            for lm in _LABEL_RE.finditer(m.group("labels")):
                labels.append((lm.group(1), _unescape(lm.group(2))))
                consumed = lm.end()
            rest = m.group("labels")[consumed:].strip(" ,")
            if rest:
                raise ValueError(f"line {lineno}: bad labels {rest!r}")
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else float(raw)
        samples[(m.group("name"), tuple(labels))] = value
    return {"types": types, "samples": samples}


def hist_from_json(d) -> Optional[Histogram]:
    """Best-effort load of a histogram dict from JSON, such as a
    summary's ``latency_hist`` (None if the shape is not a histogram)."""
    if not isinstance(d, Mapping) or "le" not in d or "counts" not in d:
        return None
    try:
        return Histogram.from_dict(d)
    except (ValueError, TypeError, KeyError):
        return None


def dumps_compact(obj) -> str:
    """Stable compact JSON (shared by the trace writers)."""
    return json.dumps(obj, separators=(",", ":"), sort_keys=True)
