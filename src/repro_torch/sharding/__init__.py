"""The placement plan: the mesh a run is laid out on and the placement of
every param, optimizer-state, batch and decode-state tensor."""
from repro_torch.sharding.ctx import Mesh, RunContext, default_ctx, make_ctx

__all__ = ["Mesh", "RunContext", "default_ctx", "make_ctx"]
