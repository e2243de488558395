"""CUDA graphs of the serving engine: one per dispatch key, captured once
and replayed.

The reference jit-compiles its decode scan once per ``n_steps`` and
its prefill once per prompt bucket, and reruns the executables; the
port's counterpart on the card is one CUDA graph per key: ``n_steps``
for a decode dispatch, ``("prefill", bucket)`` for a prefill, and
``"stream_step"`` for the prompt stream's batch-1 decode step.
:class:`StepGraphs` runs a function over tensors that keep their
address for the engine's life (every input is read from, and every
result copied into, such a tensor):

* the first call with a key runs the function eagerly on the graphs'
  capture stream -- the real call, which also does every kernel's
  first-call set-up there (library load, shared-memory attribute, the
  split decode kernels' counters, which are kept per stream) -- and
  then captures it into a memory pool that all the engine's graphs
  share;
* every later call replays the graph on the current stream; its
  outputs are the tensors the capture returned, overwritten in place,
  so a caller reads them before the next call.  All graphs draw on one
  pool, so a caller also queues every read of a graph's outputs before
  it runs any other graph: the engine scatters a prefill's K/V and
  samples its first token before a hybrid prompt's stream replays
  ``"stream_step"``.

Capture does not run the kernels, so capturing changes no state.  The
garbage collector is run before a capture and held off during it: a
graph collected while another is being captured would be destroyed
mid-capture (its ``reset`` and its pool's frees are not allowed then)
and invalidate the capture.  A
launch counter moves where a wrapper's Python code runs, i.e. in the
eager call and in the capture: the capture's delta is taken back out
and added once per replay, so :func:`repro_torch.kernels.launch_counts`
stays the launches executed.

On the CPU the function runs eagerly every time; ``run`` still reports
the first use of each key, so counts built on it (the engine's
``decode_compiles`` and ``prefill_compiles``) do not depend on the
device.  A capture or replay that fails raises
:class:`GraphCaptureError`: nothing falls back to eager on the card.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import torch

from repro_torch.kernels import add_launches, launch_counts, launch_delta

__all__ = ["GraphCaptureError", "StepGraphs"]


class GraphCaptureError(RuntimeError):
    """A CUDA graph of the engine could not be captured or replayed."""


@dataclasses.dataclass
class _Graph:
    graph: Any                     # torch.cuda.CUDAGraph
    out: Any                       # capture's outputs, rewritten by replay
    delta: Dict[str, int]          # kernel launches one replay executes
    replays: int = 0


class StepGraphs:
    """One engine's graphs, keyed by any hashable (the decode dispatch
    by ``n_steps``, a prefill by ``("prefill", bucket)``), sharing one
    memory pool and one capture stream.

    ``capture_s`` holds the seconds each capture took (``clock``, the
    engine's host clock, default ``time.perf_counter``; the eager first
    call excluded)."""

    def __init__(self, device: torch.device,
                 clock: Optional[Callable[[], float]] = None):
        self.device = device
        self.clock = clock or time.perf_counter
        self.on_card = device.type == "cuda"
        self._seen: set = set()            # keys used (CPU)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._stream = None
        self._pool = None
        self.capture_s: Dict[Hashable, float] = {}

    def run(self, key: Hashable, fn: Callable[[], Any]) -> Tuple[Any, bool]:
        """``(fn's outputs, True on the first call with key)``: eager on
        the CPU and on a key's first call on the card, else a replay."""
        if not self.on_card:
            first = key not in self._seen
            self._seen.add(key)
            return fn(), first
        if key not in self._graphs:
            return self._first_call(key, fn), True
        return self._replay(key), False

    def replays(self, key: Hashable) -> int:
        g = self._graphs.get(key)
        return 0 if g is None else g.replays

    def _first_call(self, key: Hashable, fn: Callable[[], Any]) -> Any:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = fn()
        current.wait_stream(self._stream)
        before = launch_counts()
        t0 = self.clock()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                static = fn()
        except Exception as e:
            raise GraphCaptureError(
                f"capture of the {key!r} graph failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self.capture_s[key] = self.clock() - t0
        delta = launch_delta(before, launch_counts())
        add_launches(delta, -1)           # the capture launched nothing
        self._graphs[key] = _Graph(graph, static, delta)
        return out

    def _replay(self, key: Hashable) -> Any:
        g = self._graphs[key]
        try:
            g.graph.replay()
        except Exception as e:
            raise GraphCaptureError(
                f"replay of the {key!r} graph failed: {e}") from e
        add_launches(g.delta)
        g.replays += 1
        return g.out

    def release(self) -> None:
        """Destroy every graph and drop the shared pool now (an engine
        being unloaded), outside any capture, so their memory returns
        and no later capture sees them destroyed."""
        self._graphs.clear()
        self._seen.clear()
        self._pool = None
        self._stream = None

    def pool_bytes(self) -> Optional[int]:
        """Device bytes the shared pool holds (segments the caching
        allocator reserved for it); None on the CPU, before a capture,
        or where the allocator's snapshot does not name pools."""
        if self._pool is None:
            return None
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pool = seg.get("segment_pool_id")
            if pool is None:
                continue
            named = True
            if tuple(pool) == tuple(self._pool):
                total += int(seg["total_size"])
        return total if named else None
