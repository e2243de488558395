"""Request-layer resilience: retry/hedging policy, structured admission
refusal, and the engine-side graceful-degradation ladder (the
reference's ``serving/resilience.py``):

* :class:`RetryPolicy` -- deadline + capped exponential backoff + max
  attempts, with optional tail-latency hedging (launch a duplicate after
  ``hedge_after_s`` of queueing; first to start wins, the loser is
  cancelled).  A fleet's fault layer drives it; a bare engine keeps
  ``retry_attempts`` and ``retry_hedges`` at 0.
* :class:`AdmissionRejected` -- the structured refusal the engine
  raises when the head request can never be admitted.
* :class:`DegradationLadder` -- under sustained page pressure or
  repeated admission failure the engine sheds load in a FIXED order:
  shrink the dispatch (batch) knob, then refuse new admissions instead
  of livelocking, then evict-and-checkpoint the lowest-priority lanes.
  Every transition is emitted as a ``degrade.transition`` event
  (:mod:`repro_torch.obs.events`) and counted under
  ``<engine>.degrade.*``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.analysis.invariants import invariant
from repro_torch.obs import events as obs_events

__all__ = [
    "AdmissionRejected",
    "DegradationLadder",
    "RetryPolicy",
    "DEGRADE_LEVELS",
]


# ----------------------------------------------------------------------
# retry / hedging policy
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with capped exponential backoff and optional hedging.

    ``attempt`` is 1-based: attempt 1 is the first RETRY (the initial
    try is attempt 0 and always allowed).  ``backoff_s(1)`` is
    ``base_backoff_s``; each further attempt doubles it up to
    ``backoff_cap_s``.  A request whose total sojourn exceeds
    ``deadline_s`` is not retried again (it is reported lost).

    ``hedge_after_s`` enables tail-latency hedging: a request still
    QUEUED (prefill not started) after this long gets a duplicate
    launched elsewhere; whichever copy starts first wins and the loser
    is cancelled before it consumes compute.
    """

    max_attempts: int = 3
    base_backoff_s: float = 0.05
    backoff_cap_s: float = 1.0
    deadline_s: Optional[float] = None
    hedge_after_s: Optional[float] = None

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return float(min(self.base_backoff_s * (2.0 ** max(attempt - 1, 0)),
                         self.backoff_cap_s))

    def allows(self, attempt: int, waited_s: float) -> bool:
        """May retry ``attempt`` fire, given the request has already been
        in the system for ``waited_s``?"""
        if attempt > self.max_attempts:
            return False
        if self.deadline_s is not None and waited_s >= self.deadline_s:
            return False
        return True


# ----------------------------------------------------------------------
# structured admission refusal
# ----------------------------------------------------------------------

class AdmissionRejected(RuntimeError):
    """The engine refuses (or can never grant) an admission.

    Subclasses ``RuntimeError`` and keeps the "can never be admitted"
    phrase in the terminal case.  Structured fields: ``uid``, ``reason``
    (``"never_admissible"`` or ``"backpressure"``), ``retry_after_s``
    (``None`` when retrying cannot help), ``need_pages``/``pool_pages``
    and ``n_lanes``.
    """

    def __init__(self, uid: int, reason: str,
                 retry_after_s: Optional[float] = None,
                 need_pages: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 n_lanes: Optional[int] = None,
                 message: Optional[str] = None):
        if message is None:
            if reason == "never_admissible":
                detail = (f"need={need_pages} pages of {pool_pages}"
                          if need_pages is not None else "dense")
                message = (f"request uid={uid} can never be admitted "
                           f"(n_lanes={n_lanes}, {detail}) and no request "
                           f"is in flight to retire")
            else:
                message = (f"request uid={uid} refused: engine under "
                           f"backpressure, retry after {retry_after_s}s")
        super().__init__(message)
        self.uid = uid
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.need_pages = need_pages
        self.pool_pages = pool_pages
        self.n_lanes = n_lanes


# ----------------------------------------------------------------------
# graceful degradation ladder
# ----------------------------------------------------------------------

#: ladder rungs, in escalation order (index == level)
DEGRADE_LEVELS = ("normal", "shed_batch", "backpressure", "evict")


class DegradationLadder:
    """Engine-side load shedding, escalated one rung at a time.

    Levels (``DEGRADE_LEVELS``):

    0. ``normal`` -- no intervention.
    1. ``shed_batch`` -- shrink the dispatch knob (halved per level) so
       page growth per dispatch drops and retirements come sooner.
    2. ``backpressure`` -- stop admitting NEW requests while anything is
       in flight; callers get a Retry-After hint instead of a livelock.
    3. ``evict`` -- evict-and-checkpoint the lowest-priority live lane;
       the checkpoint re-enters admission when pressure clears.

    Escalation: ``trip_after`` consecutive pressure signals (page
    occupancy >= ``page_pressure`` or a page-blocked admission) bump the
    level.  De-escalation: ``cooldown`` consecutive clear signals drop
    one rung.  Transitions are emitted as ``degrade.transition`` obs
    events; the engine counts them under ``engine.degrade.*``.
    """

    def __init__(self, page_pressure: float = 0.92, trip_after: int = 2,
                 cooldown: int = 8, min_dispatch_n: int = 1,
                 name: str = "engine"):
        invariant(0.0 < page_pressure <= 1.0,
                  "page_pressure must be in (0, 1]",
                  page_pressure=page_pressure)
        self.page_pressure = float(page_pressure)
        self.trip_after = max(1, int(trip_after))
        self.cooldown = max(1, int(cooldown))
        self.min_dispatch_n = max(1, int(min_dispatch_n))
        self.name = name
        self.level = 0
        self._strikes = 0
        self._clear = 0
        #: transition log, newest last: (from_level, to_level, reason)
        self.transitions: List[tuple] = []

    # -- signals --------------------------------------------------------
    def note_pressure(self, occupancy: float) -> None:
        """Feed one page-occupancy sample (0..1), typically once per
        dispatch boundary."""
        if occupancy >= self.page_pressure:
            self._strike(f"page_pressure={occupancy:.2f}")
        else:
            self._relax()

    def note_admission_blocked(self, uid: int) -> None:
        """An admission was refused for pages while lanes were free."""
        self._strike(f"admission_blocked uid={uid}")

    def note_ok(self) -> None:
        """One clear signal (admission succeeded / pressure is low)."""
        self._relax()

    def escalate(self, reason: str) -> bool:
        """Force one rung UP (an external controller's call -- e.g. the
        SLO burn-rate monitor paging on latency, not page pressure).
        Bypasses the strike counter; returns True if the level moved."""
        if self.level >= 3:
            return False
        self._move(self.level + 1, reason)
        self._strikes = 0
        return True

    def deescalate(self, reason: str) -> bool:
        """Force one rung DOWN (external controller's all-clear).
        Bypasses the cooldown counter; returns True if the level
        moved."""
        if self.level <= 0:
            return False
        self._move(self.level - 1, reason)
        self._clear = 0
        return True

    # -- queries --------------------------------------------------------
    @property
    def level_name(self) -> str:
        return DEGRADE_LEVELS[self.level]

    def dispatch_n(self, base: int) -> int:
        """Dispatch size under the current level (halved per rung)."""
        return max(self.min_dispatch_n, base >> self.level)

    @property
    def refusing_admissions(self) -> bool:
        return self.level >= 2

    @property
    def should_evict(self) -> bool:
        return self.level >= 3

    def retry_after_s(self, base: float = 0.05) -> float:
        """Retry-After hint: grows with the ladder level."""
        return float(base * (2.0 ** max(self.level - 1, 0)))

    # -- internals ------------------------------------------------------
    def _strike(self, reason: str) -> None:
        self._clear = 0
        self._strikes += 1
        if self._strikes >= self.trip_after and self.level < 3:
            self._move(self.level + 1, reason)
            self._strikes = 0

    def _relax(self) -> None:
        self._strikes = 0
        if self.level == 0:
            return
        self._clear += 1
        if self._clear >= self.cooldown:
            self._move(self.level - 1, "cooldown")
            self._clear = 0

    def _move(self, new_level: int, reason: str) -> None:
        old = self.level
        self.level = new_level
        self.transitions.append((old, new_level, reason))
        obs_events.emit("degrade.transition", engine=self.name,
                        from_level=DEGRADE_LEVELS[old],
                        to_level=DEGRADE_LEVELS[new_level], reason=reason)
