"""Dispatch-span tracer: host-clock spans around the real hot paths.

A copy of the reference's ``obs/trace.py``.  A :class:`SpanTracer`
records closed intervals (``Span``) on named *tracks* -- one per engine
and one per lane -- plus instant events.  Two clock disciplines:

* **host clock** (default ``time.perf_counter``): spans opened with the
  :meth:`span` context manager time host work -- the Python dispatch,
  the token read-back, the page gather/scatter.  Nothing is inserted
  into a captured CUDA graph or a kernel, and no span synchronises the
  device, so tracing cannot change what is captured or what tokens come
  out.  On the card a span therefore closes when the host has queued
  its launches, unless the host waited on the device inside it (the
  decode dispatch's token read-back does).
* **explicit clock**: :meth:`add_span` / :meth:`add_instant` record
  given times (hand-built timelines, replayed traces).

Exports Chrome-trace / Perfetto JSON (:meth:`export_chrome_trace`,
load the file at https://ui.perfetto.dev) and feeds per-span durations
into a :class:`~repro_torch.obs.metrics.MetricsRegistry` histogram
(``span.<name>.seconds``) when one is attached.

A disabled tracer (``enabled=False``) costs one attribute check and a
shared null context manager per call site -- engines construct one by
default so call sites never branch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

_NULL_CM = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    """One closed interval on a track (seconds; ``args`` is free-form)."""

    name: str
    track: str
    t0: float
    t1: Optional[float] = None
    args: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        assert self.t1 is not None, f"span {self.name!r} still open"
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class Instant:
    """A zero-duration marker on a track."""

    name: str
    track: str
    t: float
    args: Dict[str, object] = dataclasses.field(default_factory=dict)


class SpanTracer:
    """Span recorder with per-track stacks (see module docstring)."""

    def __init__(self, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 span_metric_prefix: str = "span"):
        self.enabled = enabled
        self.clock = clock or time.perf_counter
        self.registry = registry
        self.span_metric_prefix = span_metric_prefix
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self._stacks: Dict[str, List[Span]] = {}
        #: optional taps (e.g. a flight recorder's ring buffer), called
        #: with each closed Span / recorded Instant
        self.on_span: Optional[Callable[[Span], None]] = None
        self.on_instant: Optional[Callable[[Instant], None]] = None

    # -- recording ------------------------------------------------------
    def span(self, name: str, track: str = "main", **args):
        """Context manager timing a host-side block; no-op when disabled."""
        if not self.enabled:
            return _NULL_CM
        return self._span_cm(name, track, args)

    @contextlib.contextmanager
    def _span_cm(self, name: str, track: str, args: Dict[str, object]):
        sp = Span(name=name, track=track, t0=self.clock(), args=args)
        stack = self._stacks.setdefault(track, [])
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.t1 = self.clock()
            popped = stack.pop()
            assert popped is sp, f"span nesting violated on {track!r}"
            self.spans.append(sp)
            self._observe(sp)

    def add_span(self, name: str, t0: float, t1: float,
                 track: str = "main", **args) -> Optional[Span]:
        """Record an explicit interval (the sim-clock path)."""
        if not self.enabled:
            return None
        assert t1 >= t0, f"span {name!r}: t1 < t0"
        sp = Span(name=name, track=track, t0=t0, t1=t1, args=args)
        self.spans.append(sp)
        self._observe(sp)
        return sp

    def instant(self, name: str, track: str = "main",
                **args) -> Optional[Instant]:
        if not self.enabled:
            return None
        ev = Instant(name=name, track=track, t=self.clock(), args=args)
        self.instants.append(ev)
        if self.on_instant is not None:
            self.on_instant(ev)
        return ev

    def add_instant(self, name: str, t: float, track: str = "main",
                    **args) -> Optional[Instant]:
        """Record an instant at an explicit timestamp (the sim-clock
        path -- :meth:`instant` reads the host clock)."""
        if not self.enabled:
            return None
        ev = Instant(name=name, track=track, t=t, args=args)
        self.instants.append(ev)
        if self.on_instant is not None:
            self.on_instant(ev)
        return ev

    def instants_named(self, name: str) -> List[Instant]:
        return [e for e in self.instants if e.name == name]

    def _observe(self, sp: Span) -> None:
        if self.registry is not None:
            self.registry.histogram(
                f"{self.span_metric_prefix}.{sp.name}.seconds",
                help=f"host seconds inside {sp.name!r} spans",
            ).observe(sp.duration_s)
        if self.on_span is not None:
            self.on_span(sp)

    # -- queries --------------------------------------------------------
    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def tracks(self) -> List[str]:
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.track)
        for e in self.instants:
            seen.setdefault(e.track)
        return list(seen)

    def check_well_nested(self) -> bool:
        """Per track: any two spans are disjoint or strictly contained
        (no partial overlap), and every span is closed and monotone."""
        by_track: Dict[str, List[Span]] = {}
        for s in self.spans:
            if s.t1 is None or s.t1 < s.t0:
                return False
            by_track.setdefault(s.track, []).append(s)
        for spans in by_track.values():
            spans = sorted(spans, key=lambda s: (s.t0, -s.t1))
            stack: List[Span] = []
            for s in spans:
                while stack and stack[-1].t1 <= s.t0:
                    stack.pop()
                if stack and s.t1 > stack[-1].t1:
                    return False                 # partial overlap
                stack.append(s)
        return True

    # -- export ---------------------------------------------------------
    def export_chrome_trace(self) -> Dict[str, object]:
        """Chrome-trace ("trace event") JSON object, Perfetto-loadable.

        Timestamps are microseconds relative to the earliest event, one
        ``tid`` per track (named via metadata events), complete events
        (``ph: "X"``) for spans and thread-scoped instants (``ph: "i"``).
        """
        tids = {tr: i for i, tr in enumerate(sorted(self.tracks()))}
        t_base = min(
            [s.t0 for s in self.spans] + [e.t for e in self.instants],
            default=0.0)

        def us(t: float) -> float:
            return (t - t_base) * 1e6

        events: List[Dict[str, object]] = [
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
             "args": {"name": tr}}
            for tr, tid in tids.items()]
        for s in self.spans:
            assert s.t1 is not None, f"open span {s.name!r} at export"
            events.append({
                "name": s.name, "ph": "X", "pid": 0,
                "tid": tids[s.track], "ts": us(s.t0),
                "dur": (s.t1 - s.t0) * 1e6, "cat": "serving",
                "args": dict(s.args)})
        for e in self.instants:
            events.append({
                "name": e.name, "ph": "i", "s": "t", "pid": 0,
                "tid": tids[e.track], "ts": us(e.t), "cat": "serving",
                "args": dict(e.args)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        return json.dumps(self.export_chrome_trace())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export_chrome_trace(), f, indent=2)
