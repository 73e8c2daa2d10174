"""Continuous-batching serving: engine, scheduler, state pool, sampling,
speculative decoding, and the service plane (bounded admission with
deadline feasibility, ``Service``, the HTTP/SSE ``HttpFrontDoor``;
``serving.faults`` injects faults deterministically)."""
from repro_torch.serving.admission import (AdmissionConfig,
                                           AdmissionController, Verdict)
from repro_torch.serving.engine import (Engine, Request, RequestResult,
                                        serial_decode, summarize_results)
from repro_torch.serving.sampling import GREEDY, SamplingConfig
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.service import (HttpFrontDoor, Service,
                                         ServiceConfig, Ticket)
from repro_torch.serving.speculative import SpecDecoder, check_drafter_compat
from repro_torch.serving.state_pool import init_pool

__all__ = ["AdmissionConfig", "AdmissionController", "Engine", "GREEDY",
           "HttpFrontDoor", "Request", "RequestResult", "SamplingConfig",
           "Scheduler", "SchedulerConfig", "Service", "ServiceConfig",
           "SpecDecoder", "Ticket", "Verdict", "check_drafter_compat",
           "init_pool", "serial_decode", "summarize_results"]
