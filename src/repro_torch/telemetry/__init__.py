"""Serving telemetry plane: metrics registry, span recorder, clocks.

Standard library only. The stats dicts stay the writable source of truth,
the registry reads them at render time, and span recording happens only on
the thread that steps the engine (the front door's pump), through the
injectable clock.
"""
from . import schema
from .clock import default_clock, wall_clock
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      dumps_compact, escape_label, hist_from_json,
                      parse_exposition)
from .spans import SpanRecorder, write_trace

__all__ = [
    "schema", "default_clock", "wall_clock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "dumps_compact",
    "escape_label", "hist_from_json", "parse_exposition",
    "SpanRecorder", "write_trace",
]
