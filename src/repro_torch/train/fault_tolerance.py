"""Fault tolerance: resumable loop, straggler detection, elastic re-mesh;
a copy of the reference's ``train/fault_tolerance.py`` over the port's
checkpointer.

Three mechanisms:

* **Checkpoint/restart** -- ``run_resumable`` wires the async
  checkpointer into the training loop and restarts from the last
  committed step after a (simulated or real) failure; data determinism
  (counter-based PRNG keyed by step) makes restarts bit-stable.
* **Straggler detection** -- :class:`StragglerMonitor` keeps a per-host
  EWMA of step times and flags hosts slower than ``threshold`` x the
  fleet median; the orchestrator reacts by evicting/replacing the host
  (here: callback).
* **Elastic re-mesh** -- :func:`elastic_remesh_plan` computes the
  largest (data', model) mesh that fits the surviving host set, so the
  job resumes from checkpoint on fewer nodes instead of dying (model
  axis is preserved; the data axis shrinks -- batch is re-sharded);
  :func:`elastic_resume` restores the checkpoint onto that mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


# ----------------------------------------------------------------------
# straggler detection
# ----------------------------------------------------------------------

class StragglerMonitor:
    """Per-host EWMA of step times; flags hosts slower than ``threshold``
    x the fleet median.

    The clock is INJECTABLE (``clock``, defaults to ``time.monotonic``):
    under the fleet simulator the monitor runs on the sim clock, so
    derate detection is deterministic and testable.  Interval timing is
    explicit -- ``begin(host)`` marks the start of a host's step,
    ``end(host)`` reads the clock, records the elapsed interval and
    returns it; ``record`` remains for callers that measure externally.
    """

    def __init__(self, n_hosts: int, alpha: float = 0.2,
                 threshold: float = 1.5, warmup: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.ewma = np.zeros(n_hosts)
        self.count = np.zeros(n_hosts, dtype=int)
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.clock = clock
        self._open: Dict[int, float] = {}

    @property
    def n_hosts(self) -> int:
        return int(self.ewma.shape[0])

    def add_host(self) -> int:
        """Grow the host set by one (elastic fleets); returns the new
        host index."""
        self.ewma = np.append(self.ewma, 0.0)
        self.count = np.append(self.count, 0)
        return self.n_hosts - 1

    def reset(self, host: int) -> None:
        """Forget a host's history: a crashed/replaced host must neither
        be flagged on stale data nor skew the fleet median (it re-warms
        from scratch if it comes back)."""
        self.ewma[host] = 0.0
        self.count[host] = 0
        self._open.pop(host, None)

    def begin(self, host: int) -> None:
        """Mark the start of ``host``'s step on the injected clock."""
        self._open[host] = self.clock()

    def end(self, host: int) -> float:
        """Close the open interval for ``host``, record it, return it."""
        dt = self.clock() - self._open.pop(host)
        self.record(host, dt)
        return dt

    def record(self, host: int, step_seconds: float) -> None:
        if self.count[host] == 0:
            self.ewma[host] = step_seconds
        else:
            self.ewma[host] = (self.alpha * step_seconds
                               + (1 - self.alpha) * self.ewma[host])
        self.count[host] += 1

    def stragglers(self) -> List[int]:
        ready = self.count >= self.warmup
        if not np.any(ready):
            return []
        med = float(np.median(self.ewma[ready]))
        if med <= 0.0:
            return []
        return [int(i) for i in np.nonzero(
            ready & (self.ewma > self.threshold * med))[0]]


# ----------------------------------------------------------------------
# elastic re-mesh
# ----------------------------------------------------------------------

def elastic_remesh_plan(n_alive_chips: int, model_parallel: int,
                        min_data: int = 1) -> Optional[Tuple[int, int]]:
    """Largest (data, model) mesh on surviving chips, preserving TP width.

    TP degree must not change (weight shards are per-TP-rank); the data
    axis absorbs the loss.  Returns None if fewer than one TP group
    survives.
    """
    data = n_alive_chips // model_parallel
    if data < min_data:
        return None
    return (data, model_parallel)


def elastic_resume(directory: str, cfg, mesh, device,
                   moment_dtype: str = "f32"):
    """Resume on the mesh of the ranks that survived (shaped by
    :func:`elastic_remesh_plan`): the latest committed step of
    ``directory``, whatever mesh wrote it, restored into a state placed
    on ``mesh`` -- each rank reads its blocks.  Returns ``(step,
    state)``; raises when no step is committed."""
    from repro_torch.checkpoint import empty_train_state, restore_latest
    from repro_torch.parallel import use_mesh
    with use_mesh(mesh):
        template = empty_train_state(cfg, device, moment_dtype, mesh)
        step, state = restore_latest(directory, template)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under "
                                f"{directory}")
    return step, state


# ----------------------------------------------------------------------
# resumable loop (single-host demonstration harness; the multi-host
# version differs only in where save/restore run)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class LoopReport:
    steps_run: int
    restarts: int
    final_step: int
    losses: List[float]


def run_resumable(train_step: Callable, init_state: Callable,
                  make_batch: Callable, ckpt, total_steps: int,
                  ckpt_every: int = 10,
                  failure_injector: Optional[Callable[[int], bool]] = None,
                  max_restarts: int = 5) -> LoopReport:
    """Run to ``total_steps`` surviving injected failures.

    ``failure_injector(step) -> bool`` raises a simulated preemption when
    True; the loop restores from the last committed checkpoint and
    continues.
    """
    restarts = 0
    losses: List[float] = []

    while True:
        step, state = ckpt.directory and _try_restore(ckpt, init_state) \
            or (0, init_state())
        try:
            while step < total_steps:
                batch = make_batch(step)
                if failure_injector is not None and failure_injector(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state, metrics = train_step(state, batch)
                losses.append(float(metrics["loss"]))
                step += 1
                if step % ckpt_every == 0 or step == total_steps:
                    ckpt.save(step, state)
            ckpt.wait()
            return LoopReport(steps_run=len(losses), restarts=restarts,
                              final_step=step, losses=losses)
        except RuntimeError:
            restarts += 1
            ckpt.wait()
            if restarts > max_restarts:
                raise


def _try_restore(ckpt, init_state):
    from repro_torch.checkpoint import restore_latest
    template = init_state()
    step, state = restore_latest(ckpt.directory, template)
    if step is None:
        return (0, template)
    return (step, state)
