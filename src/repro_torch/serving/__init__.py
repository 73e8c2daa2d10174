"""Continuous-batching serving: engine, scheduler, state pool, sampling."""
from repro_torch.serving.engine import (Engine, Request, RequestResult,
                                        serial_decode, summarize_results)
from repro_torch.serving.scheduler import SchedulerConfig

__all__ = ["Engine", "Request", "RequestResult", "SchedulerConfig",
           "serial_decode", "summarize_results"]
