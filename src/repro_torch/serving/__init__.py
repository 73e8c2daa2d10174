"""Continuous-batching serving: engine, scheduler, state pool, sampling,
speculative decoding."""
from repro_torch.serving.engine import (Engine, Request, RequestResult,
                                        serial_decode, summarize_results)
from repro_torch.serving.sampling import GREEDY, SamplingConfig
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.speculative import SpecDecoder, check_drafter_compat

__all__ = ["Engine", "GREEDY", "Request", "RequestResult", "SamplingConfig",
           "SchedulerConfig", "SpecDecoder", "check_drafter_compat",
           "serial_decode", "summarize_results"]
