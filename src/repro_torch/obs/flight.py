"""Fault flight recorder: a bounded ring of recent telemetry per engine.

A copy of the reference's ``obs/flight.py``.  When a sanitizer trips or
an invariant fires, the evidence -- the spans, events, and metric values
leading up to the faulting op -- lives in process memory and dies with
it.  The flight recorder keeps the last ``capacity`` records in a ring
buffer (bounded, so an always-on recorder costs O(capacity) memory and
one append per record) and dumps them to ``flight_<engine>.jsonl`` at
the faulting op: an :class:`~repro_torch.analysis.invariants.
InvariantError` (or its subclass :class:`~repro_torch.analysis.
sanitizer.SanitizerError`) raised inside a :func:`flight_guard`-wrapped
engine op dumps before re-raising.

The dump is JSONL like ``pages.jsonl``: a header line (engine, reason,
drop count, op), then one record per line, oldest first -- replayable
offline with :meth:`FlightRecorder.load`.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.invariants import InvariantError

__all__ = ["FlightRecorder", "flight_guard", "iter_flight_dumps"]


class FlightRecorder:
    """Bounded ring buffer of spans / events / metric snapshots.

    Attach to a tracer/event log with :meth:`attach` (tap hooks -- no
    per-call-site plumbing), snapshot a registry with
    :meth:`snapshot_metrics`, dump with :meth:`dump`.  Records older
    than ``capacity`` fall off the front; ``n_dropped`` counts them so a
    dump is honest about what it no longer holds.
    """

    def __init__(self, name: str = "engine", capacity: int = 256):
        self.name = name
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.n_seen = 0
        self.n_dumps = 0
        self.dump_paths: List[str] = []

    # -- recording ------------------------------------------------------
    def record(self, kind: str, **payload: Any) -> None:
        self.n_seen += 1
        self._ring.append({"kind": kind, **payload})

    def record_span(self, span) -> None:
        self.record("span", name=span.name, track=span.track,
                    t0=span.t0, t1=span.t1, args=dict(span.args))

    def record_instant(self, instant) -> None:
        self.record("instant", name=instant.name, track=instant.track,
                    t=instant.t, args=dict(instant.args))

    def record_event(self, event) -> None:
        self.record("event", name=event.name, t=event.t,
                    fields=dict(event.fields))

    def snapshot_metrics(self, registry, t: Optional[float] = None) -> None:
        """Record one full registry snapshot (typically at a dispatch
        boundary or right before a dump)."""
        self.record("metrics", t=t, values=registry.collect())

    def attach(self, tracer=None, log=None) -> "FlightRecorder":
        """Tap a tracer's span/instant hooks and/or an event log's emit
        hook.  Chains any hook already installed (tap fan-out)."""
        if tracer is not None:
            prev_s, prev_i = tracer.on_span, tracer.on_instant
            tracer.on_span = (self.record_span if prev_s is None else
                              lambda sp: (prev_s(sp),
                                          self.record_span(sp)))
            tracer.on_instant = (self.record_instant if prev_i is None
                                 else lambda ev: (prev_i(ev),
                                                  self.record_instant(ev)))
        if log is not None:
            prev_e = log.on_emit
            log.on_emit = (self.record_event if prev_e is None else
                           lambda ev: (prev_e(ev),
                                       self.record_event(ev)))
        return self

    # -- introspection --------------------------------------------------
    @property
    def n_dropped(self) -> int:
        return max(self.n_seen - len(self._ring), 0)

    def __len__(self) -> int:
        return len(self._ring)

    def records(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def tail(self, n: int) -> List[Dict[str, Any]]:
        return list(self._ring)[-n:]

    # -- dump / load ----------------------------------------------------
    def default_path(self) -> str:
        return f"flight_{self.name}.jsonl"

    def dump(self, path: Optional[str] = None, reason: str = "",
             registry=None, **extra: Any) -> str:
        """Write header + ring to ``path`` (default
        ``flight_<name>.jsonl``), oldest record first.  With a
        ``registry``, a final metrics snapshot is appended first so the
        dump carries the counters at the faulting op.  Returns the
        path written."""
        if registry is not None:
            self.snapshot_metrics(registry)
        path = path or self.default_path()
        header = {"flight": self.name, "reason": reason,
                  "capacity": self.capacity, "n_records": len(self._ring),
                  "n_dropped": self.n_dropped, **extra}
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for rec in self._ring:
                f.write(json.dumps(rec) + "\n")
        self.n_dumps += 1
        self.dump_paths.append(path)
        return path

    @staticmethod
    def load(path) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
        """Offline replay: returns ``(header, records)`` from a dump."""
        with open(path) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        if not lines:
            return {}, []
        return lines[0], lines[1:]


class flight_guard:
    """Context manager dumping ``recorder`` when a lifecycle error
    escapes the guarded op, then re-raising.

    Triggers on :class:`~repro_torch.analysis.invariants.InvariantError`
    and its subclasses (:class:`~repro_torch.analysis.sanitizer.
    SanitizerError` among them) and on nothing else: any other
    exception passes through without a dump.  ``recorder=None`` is a
    no-op guard, letting call sites stay branch-free.
    """

    def __init__(self, recorder: Optional[FlightRecorder],
                 op: str = "", registry=None):
        self.recorder = recorder
        self.op = op
        self.registry = registry

    def __enter__(self) -> Optional[FlightRecorder]:
        return self.recorder

    def __exit__(self, exc_type, exc, tb) -> bool:
        if (self.recorder is not None and exc_type is not None
                and issubclass(exc_type, InvariantError)):
            self.recorder.dump(reason=f"{exc_type.__name__}: {exc}",
                               registry=self.registry, op=self.op)
        return False


def iter_flight_dumps(recorders) -> Iterator[str]:
    """Every dump path the recorders in ``recorders`` wrote, recorder by
    recorder, each in the order written."""
    for rec in recorders:
        yield from rec.dump_paths
