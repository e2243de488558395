"""SLO burn-rate monitor: observability closing the loop to control.

A copy of the reference's ``obs/slo.py``.  The
:class:`~repro_torch.serving.resilience.DegradationLadder` is driven by
*page pressure* -- an input-side signal.  This module drives the same
ladder from the OUTPUT side: declared TTFT/tpot objectives,
sliding-window violation rates, and the standard multi-window burn-rate
alert (both a short and a long window must burn faster than
``burn_threshold`` times the error budget before the alert fires; the
short window alone clears it).  Fast regressions page quickly, slow
burns still page, recovered systems de-escalate.

Clock discipline matches the tracer: observations are stamped with the
caller's timestamps (the engine's shared host clock in
:class:`~repro_torch.serving.engine.ServeEngine`, or any explicit
clock), so one monitor works on either.

Everything is published under the ``slo.*`` namespace: burn-rate
gauges, violation/alert counters, and ``slo.alert`` / ``slo.clear`` /
``slo.escalate`` / ``slo.deescalate`` events.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.obs import events as obs_events

__all__ = ["SLOObjective", "BurnRateMonitor", "SLOController"]


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """Declared latency objectives and the error budget they carry.

    ``error_budget`` is the fraction of requests ALLOWED to violate the
    objective (0.1: one in ten may miss).  Burn rate 1.0 means the
    budget is being consumed exactly at the sustainable rate; rate N
    exhausts it N times too fast.
    """

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    error_budget: float = 0.1

    def __post_init__(self):
        if not (0.0 < self.error_budget <= 1.0):
            raise ValueError(f"error_budget must be in (0, 1], got "
                             f"{self.error_budget}")


class _Window:
    """Sliding window of (t, violated) samples with O(1) amortized
    pruning and a running violation count."""

    def __init__(self, width_s: float):
        self.width_s = float(width_s)
        self._samples: Deque[Tuple[float, bool]] = deque()
        self._violations = 0

    def add(self, t: float, violated: bool) -> None:
        self._samples.append((t, violated))
        if violated:
            self._violations += 1
        self.prune(t)

    def prune(self, now: float) -> None:
        cutoff = now - self.width_s
        while self._samples and self._samples[0][0] < cutoff:
            _, v = self._samples.popleft()
            if v:
                self._violations -= 1

    def violation_rate(self, now: float) -> float:
        self.prune(now)
        if not self._samples:
            return 0.0
        return self._violations / len(self._samples)

    def __len__(self) -> int:
        return len(self._samples)


class BurnRateMonitor:
    """Multi-window burn-rate alerting over TTFT/tpot observations.

    Feed :meth:`observe_ttft` / :meth:`observe_tpot` with explicit
    timestamps (any monotone clock).  :meth:`update` recomputes burn
    rates and flips :attr:`alert` with hysteresis: it FIRES when both
    the short and long window burn above ``burn_threshold``, and CLEARS
    when the short window burns below ``clear_threshold`` (the long
    window keeps history of the incident; waiting for it would hold the
    alert long after recovery).
    """

    def __init__(self, objective: SLOObjective,
                 short_window_s: float = 5.0,
                 long_window_s: float = 30.0,
                 burn_threshold: float = 2.0,
                 clear_threshold: float = 1.0,
                 registry=None, name: str = "slo"):
        if short_window_s >= long_window_s:
            raise ValueError("short window must be shorter than long")
        self.objective = objective
        self.short = _Window(short_window_s)
        self.long = _Window(long_window_s)
        self.burn_threshold = float(burn_threshold)
        self.clear_threshold = float(clear_threshold)
        self.registry = registry
        self.name = name
        self.alert = False
        self.alerts_fired = 0
        self.t_last: float = 0.0
        if registry is not None:
            registry.gauge(f"{name}.burn_rate.short",
                           help="short-window error-budget burn rate")
            registry.gauge(f"{name}.burn_rate.long",
                           help="long-window error-budget burn rate")
            registry.counter(f"{name}.violations.ttft")
            registry.counter(f"{name}.violations.tpot")
            registry.counter(f"{name}.alerts")

    # -- feeding --------------------------------------------------------
    def _observe(self, kind: str, violated: bool, t: float) -> None:
        self.t_last = max(self.t_last, t)
        self.short.add(t, violated)
        self.long.add(t, violated)
        if violated and self.registry is not None:
            self.registry.counter(
                f"{self.name}.violations.{kind}").inc()

    def observe_ttft(self, value_s: float, t: float) -> bool:
        """Record one request's TTFT at time ``t``; returns violated.
        A ``None`` objective means TTFT carries no budget: the sample
        is dropped entirely (it must not dilute the tpot burn rate)."""
        lim = self.objective.ttft_s
        if lim is None:
            return False
        violated = value_s > lim
        self._observe("ttft", violated, t)
        return violated

    def observe_tpot(self, value_s: float, t: float) -> bool:
        """Record one seconds/token sample at time ``t`` (dropped when
        the objective declares no tpot target)."""
        lim = self.objective.tpot_s
        if lim is None:
            return False
        violated = value_s > lim
        self._observe("tpot", violated, t)
        return violated

    # -- alerting -------------------------------------------------------
    def burn_rates(self, now: Optional[float] = None
                   ) -> Tuple[float, float]:
        now = self.t_last if now is None else now
        budget = self.objective.error_budget
        return (self.short.violation_rate(now) / budget,
                self.long.violation_rate(now) / budget)

    def update(self, now: Optional[float] = None) -> bool:
        """Recompute burn rates, update the alert state (with
        hysteresis), publish gauges/events.  Returns :attr:`alert`."""
        now = self.t_last if now is None else now
        short_burn, long_burn = self.burn_rates(now)
        if self.registry is not None:
            self.registry.gauge(
                f"{self.name}.burn_rate.short").set(short_burn)
            self.registry.gauge(
                f"{self.name}.burn_rate.long").set(long_burn)
        if not self.alert:
            if (short_burn >= self.burn_threshold
                    and long_burn >= self.burn_threshold):
                self.alert = True
                self.alerts_fired += 1
                if self.registry is not None:
                    self.registry.counter(f"{self.name}.alerts").inc()
                obs_events.emit(f"{self.name}.alert", t=now,
                                short_burn=round(short_burn, 4),
                                long_burn=round(long_burn, 4))
        elif short_burn <= self.clear_threshold:
            self.alert = False
            obs_events.emit(f"{self.name}.clear", t=now,
                            short_burn=round(short_burn, 4),
                            long_burn=round(long_burn, 4))
        return self.alert


class SLOController:
    """Close the loop: burn-rate alerts drive the degradation ladder.

    While the monitor is alerting, :meth:`step` escalates the ladder one
    rung every ``escalate_every_s`` (first escalation immediately); once
    the alert clears, it de-escalates one rung every ``relax_every_s``
    until the ladder is back to normal.  Every action lands in
    :attr:`actions` and as an ``slo.escalate`` / ``slo.deescalate``
    event, so a replay demonstrably shows the observability->control
    loop closing.
    """

    def __init__(self, monitor: BurnRateMonitor, ladder,
                 escalate_every_s: float = 1.0,
                 relax_every_s: float = 2.0):
        self.monitor = monitor
        self.ladder = ladder
        self.escalate_every_s = float(escalate_every_s)
        self.relax_every_s = float(relax_every_s)
        #: (t, "escalate"|"deescalate", new_level_name), newest last
        self.actions: List[Tuple[float, str, str]] = []
        self._t_last_action: Optional[float] = None

    def _due(self, now: float, period_s: float) -> bool:
        return (self._t_last_action is None
                or now - self._t_last_action >= period_s)

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """Update the monitor and apply at most one ladder move.
        Returns the action taken (``"escalate"`` / ``"deescalate"`` /
        ``None``)."""
        now = self.monitor.t_last if now is None else now
        alerting = self.monitor.update(now)
        name = self.monitor.name
        if alerting and self.ladder.level < 3 \
                and self._due(now, self.escalate_every_s):
            self.ladder.escalate(f"{name}_burn")
            self._t_last_action = now
            self.actions.append((now, "escalate", self.ladder.level_name))
            obs_events.emit(f"{name}.escalate", t=now,
                            level=self.ladder.level_name)
            return "escalate"
        if not alerting and self.ladder.level > 0 \
                and self._due(now, self.relax_every_s):
            self.ladder.deescalate(f"{name}_recovered")
            self._t_last_action = now
            self.actions.append((now, "deescalate",
                                 self.ladder.level_name))
            obs_events.emit(f"{name}.deescalate", t=now,
                            level=self.ladder.level_name)
            return "deescalate"
        return None

    @property
    def escalated(self) -> bool:
        return any(a == "escalate" for _, a, _ in self.actions)

    @property
    def deescalated(self) -> bool:
        return any(a == "deescalate" for _, a, _ in self.actions)
