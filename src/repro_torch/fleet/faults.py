"""Deterministic fault injection for the fleet: plans, injector, recovery
(the reference's ``fleet/faults.py`` over the port's ``RetryPolicy`` and
``MetricsRegistry``).

Salvaged mining boards are not datacenter parts: a CMP 170HX drops off
the bus, its PCIe-1.1-x4 host link flaps, thermals derate the clock.
This module makes those regimes first-class and DETERMINISTIC -- a
:class:`FaultPlan` is a seeded, immutable schedule of fault events that
plugs into the reference's discrete-event simulator
(``FleetSim(faults=...)``) and into the execution-backed replay on the
port's engine (:func:`repro_torch.fleet.execution.run_trace_with_faults`):

* events scheduled **by sim time** (``at_s``) drive a simulator (the
  port has none yet: it keeps them so a plan is the reference's);
* events scheduled **by dispatch index** (``at_dispatch``) drive the
  replay, where "time" is the decode dispatch counter.

Fault taxonomy (``FaultEvent.kind``):

========== ============================================================
``crash``     node fails permanently; live lanes recover via checkpoint
              migration (``Router.route_migration``) or replay-from-
              prompt when no checkpoint interval has elapsed
``derate``    compute/thermal derate: step and prefill times dilate by
              ``factor`` for ``duration_s`` (or forever)
``link``      host-link degradation/flap: PCIe transfer times dilate by
              ``factor`` for ``duration_s``
``transient`` transient dispatch error: the node stalls for
              ``duration_s`` (sim) / one dispatch is retried (replay)
========== ============================================================

:class:`RecoveryPolicy` bundles the checkpoint cadence with a
:class:`~repro_torch.serving.resilience.RetryPolicy`; counters land in the
``fleet.faults.*`` / ``fleet.retry.*`` registry namespace via
:class:`FaultInjector`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.resilience import RetryPolicy

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "FaultInjector",
    "RecoveryPolicy",
    "RetryPolicy",
]

FAULT_KINDS = ("crash", "derate", "link", "transient")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``node`` selects the target: an int indexes the ALIVE node set
    (sorted by ``node_id``, modulo its size -- stable under autoscaling
    and prior crashes), a str matches a ``node_id`` exactly.  Exactly
    one of ``at_s`` (sim clock) / ``at_dispatch`` (replay dispatch
    index) must be set.
    """

    kind: str
    node: Union[int, str] = 0
    at_s: Optional[float] = None
    at_dispatch: Optional[int] = None
    factor: float = 1.0               # derate/link dilation (>= 1)
    duration_s: Optional[float] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if (self.at_s is None) == (self.at_dispatch is None):
            raise ValueError("exactly one of at_s / at_dispatch must be set")
        if self.factor < 1.0:
            raise ValueError("factor dilates time; must be >= 1")
        if self.kind == "transient" and self.at_s is not None \
                and self.duration_s is None:
            raise ValueError("sim-time transient faults need duration_s")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable, ordered schedule of :class:`FaultEvent`."""

    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    # -- construction ---------------------------------------------------
    @classmethod
    def seeded(cls, seed: int, n_nodes: int, horizon_s: float,
               n_crashes: int = 1, n_derates: int = 1, n_links: int = 1,
               n_transients: int = 1, derate_factor: float = 2.0,
               link_factor: float = 4.0,
               transient_s: float = 0.25) -> "FaultPlan":
        """Deterministic random plan over ``[0.1, 0.9] * horizon_s``.

        Crashes land in the middle half of the horizon so a "kill a node
        mid-trace" scenario is the default; windows (derate/link) last a
        random 10-30% of the horizon.
        """
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(n_crashes):
            events.append(FaultEvent(
                "crash", node=int(rng.integers(n_nodes)),
                at_s=float(rng.uniform(0.25, 0.75) * horizon_s)))
        for kind, n, factor in (("derate", n_derates, derate_factor),
                                ("link", n_links, link_factor)):
            for _ in range(n):
                events.append(FaultEvent(
                    kind, node=int(rng.integers(n_nodes)),
                    at_s=float(rng.uniform(0.1, 0.6) * horizon_s),
                    factor=factor,
                    duration_s=float(rng.uniform(0.1, 0.3) * horizon_s)))
        for _ in range(n_transients):
            events.append(FaultEvent(
                "transient", node=int(rng.integers(n_nodes)),
                at_s=float(rng.uniform(0.1, 0.9) * horizon_s),
                duration_s=transient_s))
        events.sort(key=lambda e: (e.at_s, e.kind, str(e.node)))
        return cls(tuple(events))

    @classmethod
    def flap(cls, node: Union[int, str], t0: float, period_s: float,
             n_flaps: int, factor: float = 4.0) -> "FaultPlan":
        """A flapping host link: ``n_flaps`` degradation windows of
        ``period_s / 2`` starting at ``t0``, one per ``period_s``."""
        events = tuple(
            FaultEvent("link", node=node, at_s=t0 + i * period_s,
                       factor=factor, duration_s=period_s / 2.0)
            for i in range(n_flaps))
        return cls(events)

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        merged = sorted(
            self.events + other.events,
            key=lambda e: (e.at_s if e.at_s is not None else float(
                e.at_dispatch), e.kind, str(e.node)))
        return FaultPlan(tuple(merged))

    # -- views ----------------------------------------------------------
    def sim_events(self) -> List[FaultEvent]:
        """Events scheduled on the sim clock, in time order."""
        return sorted((e for e in self.events if e.at_s is not None),
                      key=lambda e: (e.at_s, e.kind, str(e.node)))

    def crash_dispatch(self) -> Optional[int]:
        """First dispatch-indexed crash (replay mode), or None."""
        idx = [e.at_dispatch for e in self.events
               if e.kind == "crash" and e.at_dispatch is not None]
        return min(idx) if idx else None

    def transient_dispatches(self) -> List[int]:
        """Dispatch indices with a transient dispatch error (replay)."""
        return sorted(e.at_dispatch for e in self.events
                      if e.kind == "transient" and e.at_dispatch is not None)


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """How the fleet recovers from the plan's faults.

    * ``checkpoint_interval_s`` -- cadence of the host-side lane
      checkpoints the sim takes; a crashed lane restores from its last
      checkpoint (pages generated since are lost) or, if none has been
      taken yet, replays from the prompt.
    * ``retry`` -- request-layer retry/hedging policy for work the crash
      (or an exhausted router) orphaned.
    """

    checkpoint_interval_s: float = 5.0
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)


class FaultInjector:
    """Applies a :class:`FaultPlan` to a fleet and counts what it did.

    The injector owns target resolution (stable node selection under
    autoscaling/crashes) and the ``fleet.faults.*`` registry counters;
    the actual state transitions live in a simulator (sim clock) and
    ``fleet.execution`` (dispatch index), which call back into it.
    """

    COUNTERS = {
        "crash": "fleet.faults.crashes",
        "derate": "fleet.faults.derates",
        "link": "fleet.faults.link_events",
        "transient": "fleet.faults.transients",
    }

    def __init__(self, plan: FaultPlan,
                 registry: Optional[MetricsRegistry] = None):
        self.plan = plan
        self.registry = registry if registry is not None else MetricsRegistry()
        for metric in self.COUNTERS.values():
            self.registry.counter(metric).set(0)
        self.registry.counter("fleet.retry.attempts").set(0)
        self.registry.counter("fleet.retry.hedges").set(0)
        self.registry.counter("fleet.faults.requests_lost").set(0)

    def resolve(self, ev: FaultEvent, nodes: Sequence) -> Optional[object]:
        """Target node of ``ev`` among the currently-alive ``nodes``
        (objects with ``node_id``); None when nothing matches."""
        alive = [n for n in nodes if not getattr(n, "failed", False)]
        if not alive:
            return None
        if isinstance(ev.node, str):
            for n in alive:
                if n.node_id == ev.node:
                    return n
            return None
        ordered = sorted(alive, key=lambda n: n.node_id)
        return ordered[ev.node % len(ordered)]

    def count(self, kind: str, n: int = 1) -> None:
        self.registry.counter(self.COUNTERS[kind]).inc(n)

    def count_retry(self, n: int = 1) -> None:
        self.registry.counter("fleet.retry.attempts").inc(n)

    def count_hedge(self, n: int = 1) -> None:
        self.registry.counter("fleet.retry.hedges").inc(n)

    def count_lost(self, n: int = 1) -> None:
        self.registry.counter("fleet.faults.requests_lost").inc(n)
