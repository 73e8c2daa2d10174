"""Compiled dispatch for the serving engine: each decode dispatch and each
prefill chunk captured once per key as a CUDA graph and replayed, the
port's counterpart of the reference engine's jitted ``_decode`` scan and
``_prefill`` (one executable per static window, the pool donated).

``GraphCache.run(kind, key, body)`` runs one dispatch. On the card the
first use of a key runs ``body`` eagerly: that is the real dispatch, and it
makes whatever the kernels make at first use (a library loaded, B1's
split-K and B3/B5's split-KV workspaces, which ``build.Workspaces`` refuses
to make inside a capture). The second use captures ``body``, which executes
nothing, and replays the graph for the real dispatch; every later use
replays. A key seen once never pays for a capture. A first use that raises
leaves its key unseen, so the next use runs eagerly again; a capture that
raises keeps no graph, so the next use captures again (the engine's fault
boundary serves on after both). On the CPU ``body`` runs
eagerly every time (dispatch by device, as ``kernels.ops``). Nothing turns
the graphs off and nothing falls back: a capture or a replay that fails
raises.

A graph bakes in every address and every host value its body used, so a
body reads its inputs from fixed device buffers (``Inputs``), writes its
outputs into buffers made outside the capture, and makes no host sync.
All graphs of one cache share one graph memory pool: a body's temporaries
die with its capture, and replays run one at a time in stream order.

Keys are bounded per kind (the reference's ``max_lowerings``): the
``bound + 1``-th distinct key raises.

Launch counts stay those of the device: a capture launches nothing, so the
launches its body counted (``build.Kernel.launches``) are taken back, and
credited again on every replay."""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Hashable

import numpy as np
import torch

from repro_torch.kernels import build


class Inputs:
    """Fixed device buffers, one per key, each filled from its own pinned
    host copy: a graph that read a buffer reads its new values on replay.

    ``put`` makes the buffer at the key's first use, outside any capture,
    and never makes it again. Its host-to-device copy is queued in stream
    order, ahead of the dispatch that reads it, and is skipped when the
    buffer already holds the values. The pinned copy is rewritten only
    after its previous copy ran (an event), so the host may run ahead of
    the card."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: Dict[Hashable, list] = {}

    def put(self, key: Hashable, values: np.ndarray) -> torch.Tensor:
        """The device buffer of ``key``, holding ``values`` (an array of the
        shape and dtype of the key's first put)."""
        src = torch.from_numpy(np.ascontiguousarray(values))
        buf = self._bufs.get(key)
        if buf is None:
            cuda = self.device.type == "cuda"
            buf = self._bufs[key] = [
                torch.empty(src.shape, dtype=src.dtype, device=self.device),
                torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                if cuda else None,
                torch.cuda.Event() if cuda else None, None]
        dev, host, done, held = buf
        if src.shape != dev.shape or src.dtype != dev.dtype:
            raise ValueError(f"input {key!r}: {tuple(src.shape)} {src.dtype}"
                             f" into a {tuple(dev.shape)} {dev.dtype} buffer")
        data = src.numpy().tobytes()
        if data == held:
            return dev
        if host is None:
            dev.copy_(src)
        else:
            done.synchronize()
            host.copy_(src)
            dev.copy_(host, non_blocking=True)
            done.record()
        buf[3] = data
        return dev


class GraphCache:
    """CUDA graphs of one engine's dispatches, keyed per kind (``bounds``:
    kind -> most distinct keys). Counts ``graphs_captured``,
    ``graph_replays``, ``eager_dispatches``, ``capture_s`` and
    ``graph_pool_bytes`` (device memory reserved while capturing) into
    ``stats``."""

    def __init__(self, device: torch.device, bounds: Dict[str, int],
                 stats: Dict[str, Any]):
        self.device = device
        self.bounds = dict(bounds)
        self.stats = stats
        for name in ("graphs_captured", "graph_replays", "eager_dispatches",
                     "graph_pool_bytes"):
            stats.setdefault(name, 0)
        stats.setdefault("capture_s", 0.0)
        self.keys: Dict[str, set] = {kind: set() for kind in bounds}
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None
        # captures keep their graph's nodes for CUDAGraph.debug_dump (the
        # static checks read them; serving never sets it)
        self.debug = False

    def graph(self, kind: str, key: Hashable):
        """The CUDA graph captured for ``(kind, key)``, or None."""
        entry = self._graphs.get((kind, key))
        return None if entry is None else entry[0]

    def run(self, kind: str, key: Hashable, body: Callable[[], None]
            ) -> None:
        """One dispatch of ``body`` under ``(kind, key)``: eager at the
        key's first use (and always on the CPU), captured at its second,
        replayed from then on."""
        seen = self.keys[kind]
        first = key not in seen
        if first and len(seen) >= self.bounds[kind]:
            raise RuntimeError(
                f"{kind} dispatch key {key!r} would be the "
                f"{len(seen) + 1}-th, past the bound of "
                f"{self.bounds[kind]}: {sorted(seen, key=repr)}")
        if first or self.device.type != "cuda":
            body()
            # seen only once its eager use returned: a first use that
            # raised may not have made what a capture needs made before it
            seen.add(key)
            self.stats["eager_dispatches"] += 1
            return
        entry = self._graphs.get((kind, key))
        if entry is None:
            entry = self._graphs[(kind, key)] = self._capture(body)
        graph, credits = entry
        graph.replay()
        for kern, n in credits:
            kern.launches += n
        self.stats["graph_replays"] += 1

    def _capture(self, body: Callable[[], None]) -> tuple:
        """Capture ``body`` into a new graph in the shared pool. The launches
        it counted are taken back and returned as the credits of each
        replay."""
        t0 = time.monotonic()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # the capture empties the allocator's cache first; do it before
        # reading what is reserved, so the growth is the pool's alone
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = [k.launches for k in build.KERNELS]
        graph = (torch.cuda.CUDAGraph(keep_graph=True) if self.debug
                 else torch.cuda.CUDAGraph())
        credits = []
        # no cyclic garbage collection while capturing: a collection could
        # free a dead engine's graphs (a Service and its engine hold each
        # other) and destroying a graph mid-capture, from any thread,
        # invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                body()
            if self.debug:
                graph.instantiate()
        finally:
            if collecting:
                gc.enable()
            # a capture launches nothing, whether it ended or raised (then
            # the half-made graph is dropped and the key captured again at
            # its next use)
            for kern, n0 in zip(build.KERNELS, before):
                if kern.launches != n0:
                    credits.append((kern, kern.launches - n0))
                    kern.launches = n0
        self.stats["graph_pool_bytes"] += (
            torch.cuda.memory_reserved(self.device) - reserved)
        self.stats["graphs_captured"] += 1
        self.stats["capture_s"] += time.monotonic() - t0
        return graph, credits
