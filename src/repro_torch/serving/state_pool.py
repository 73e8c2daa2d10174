"""Per-slot decode-state pool for the continuous-batching engine (the
contiguous layout; paged KV is ROADMAP A8).

The pool is ``lm.init_decode_state(..., per_slot_pos=True)``: every cache
leaf has the slot axis first and ``pos`` is a (n_slots,) int32 tensor.
PyTorch updates in place, so a slot's state is a set of views into the
pool: a prefill through those views writes the pool's KV directly, and no
slot is ever copied out or back."""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.models import lm


def init_pool(cfg, n_slots: int, max_seq: int, params: Optional[dict] = None,
              quantized_kv: bool = False, device=None) -> Dict[str, Any]:
    """Pool for ``n_slots`` concurrent requests (per-slot ``pos``)."""
    return lm.init_decode_state(cfg, n_slots, max_seq, params=params,
                                per_slot_pos=True, quantized_kv=quantized_kv,
                                device=device)


def gather_slot(pool: Dict[str, Any], slot: int, pos: int) -> Dict[str, Any]:
    """Slot ``slot`` as a batch=1 ``decode_step`` state: views of the pool's
    caches and the host's copy of the slot's position."""
    caches = [{k: leaf[slot:slot + 1] for k, leaf in entry.items()}
              for entry in pool["caches"]]
    return {"caches": caches, "pos": pos}


def scatter_slot(pool: Dict[str, Any], slot: int,
                 state: Dict[str, Any]) -> None:
    """Record a batch=1 state's position in the pool (its KV already landed
    in the pool through the views)."""
    pool["pos"][slot] = int(state["pos"])


def reset_slot(pool: Dict[str, Any], slot: int) -> None:
    """Admission: the slot's position drops to 0. Its KV is left as it is:
    the previous occupant's entries are masked by every later attend until
    prefill overwrites them."""
    pool["pos"][slot] = 0
