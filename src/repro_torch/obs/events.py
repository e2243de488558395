"""Append-only event log: an auditable record of serving decisions.

A copy of the reference's ``obs/events.py``.  Timestamped dicts, no
levels, no handlers: the degradation ladder emits ``degrade.transition``
and the SLO controller ``slo.*`` into the process-global
:data:`DEFAULT_LOG` (``emit``), so a serve can be audited after the
fact -- ``DEFAULT_LOG.records_prefix("degrade")`` -- and exported
beside the trace.  ``clear()`` between test cases.

Clock discipline: the default clock is ``time.perf_counter`` -- the
SAME clock :class:`~repro_torch.obs.trace.SpanTracer` stamps spans with,
so a merged span/event timeline lines up without translation (lint rule
R003 flags an obs constructor handed a wall clock).  An engine that owns
both a tracer and a log injects ONE shared clock into both.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Event:
    """One audit record: timestamp (span-clock seconds), name, fields."""

    t: float
    name: str
    fields: Dict[str, object]

    def as_dict(self) -> Dict[str, object]:
        return {"t": self.t, "name": self.name, **self.fields}


class EventLog:
    """Append-only list of :class:`Event` with name filtering."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._events: List[Event] = []
        #: optional tap (e.g. a flight recorder's ring buffer): called
        #: with each Event right after it is appended
        self.on_emit = None

    @property
    def clock(self):
        """The clock this log stamps events with (shared-clock checks)."""
        return self._clock

    def emit(self, name: str, **fields) -> Event:
        ev = Event(t=self._clock(), name=name, fields=fields)
        self._events.append(ev)
        if self.on_emit is not None:
            self.on_emit(ev)
        return ev

    def records(self, name: Optional[str] = None) -> List[Event]:
        if name is None:
            return list(self._events)
        return [e for e in self._events if e.name == name]

    def records_prefix(self, prefix: str) -> List[Event]:
        """Events whose name starts with a dotted ``prefix`` -- e.g.
        ``records_prefix("degrade")`` collects every ladder transition."""
        dotted = prefix if prefix.endswith(".") else prefix + "."
        return [e for e in self._events
                if e.name == prefix or e.name.startswith(dotted)]

    def names(self) -> List[str]:
        """Distinct event names seen, in first-emission order."""
        seen: Dict[str, None] = {}
        for e in self._events:
            seen.setdefault(e.name)
        return list(seen)

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()

    def to_json(self) -> str:
        return json.dumps([e.as_dict() for e in self._events])

    def to_jsonl(self) -> str:
        """One JSON object per line -- the ``pages.jsonl`` format the
        offline sanitizer replay consumes."""
        return "\n".join(json.dumps(e.as_dict()) for e in self._events)

    def dump(self, path, prefix: Optional[str] = None) -> int:
        """Write the log (optionally filtered to a dotted ``prefix``,
        e.g. ``"page"`` for the allocator op stream) as JSONL.  Returns
        the number of records written."""
        events = (self.records_prefix(prefix) if prefix is not None
                  else self._events)
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e.as_dict()) + "\n")
        return len(events)


#: process-global default log -- what the validators emit into
DEFAULT_LOG = EventLog()


def emit(name: str, **fields) -> Event:
    """Emit into the default log (the validators' entry point)."""
    return DEFAULT_LOG.emit(name, **fields)
