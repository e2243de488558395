"""Request-scoped timelines reconstructed from the span stream.

A copy of the reference's ``obs/requests.py``.  The tracer records
*boundary*-scoped telemetry: one track per engine and per lane, spans
named for the phase (``admit``, ``decode.dispatch``, ``preempt.evict``
...).  That answers "what is the engine doing" but not "what happened
to request 17" -- a request hops lanes on re-admission, hops ENGINES on
a migration, and its decode work hides inside batch-scoped
``decode.dispatch`` spans.

The correlation key is the request ``uid``, which every span and
instant the engine emits carries (``uid=...``), and which
``decode.dispatch`` spans carry as a ``uids`` tuple (the lanes live in
that batch).  :func:`RequestTimeline.from_tracer` selects the events
belonging to one uid, orders them causally, and derives the per-request
facts the SLO layer consumes: TTFT, a tpot series (per-dispatch
seconds/token), pages touched, and the engine hops the request survived
(evict/restore, cross-engine migration, simulated migrations).

``export_request_tracks`` re-projects the same events onto one Perfetto
track per request (``req/<uid>``), so a trace viewer shows each
request's life as a single lane regardless of how many engines served
it.  ``spans_from_chrome`` inverts ``export_chrome_trace``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import Instant, Span, SpanTracer

__all__ = [
    "RequestTimeline",
    "request_ids",
    "request_timelines",
    "export_request_tracks",
    "spans_from_chrome",
]

#: span/instant names that open or close a request's residency on an
#: engine -- the hop detector keys on these
_HOP_OPENERS = ("admit", "preempt.restore", "sim.prefill", "sim.decode")


def _span_uids(args: Dict[str, object]) -> Tuple[int, ...]:
    """Request uids an event's args attribute it to (``uid`` scalar,
    ``uids`` batch tuple, or nothing)."""
    out: List[int] = []
    uid = args.get("uid")
    if uid is not None:
        out.append(int(uid))
    uids = args.get("uids")
    if uids is not None:
        out.extend(int(u) for u in uids)
    return tuple(out)


def _engine_of(track: str) -> str:
    """Engine/board a track belongs to: ``serve/lane0`` -> ``serve``,
    ``node0/u3`` -> ``node0``, ``serve`` -> ``serve``."""
    return track.split("/", 1)[0]


@dataclasses.dataclass
class RequestTimeline:
    """Causally ordered per-request view over one tracer's records.

    ``spans``/``instants`` are the tracer's own objects (shared, do not
    mutate), sorted by start time.  Derived fields:

    * ``engines`` -- boards that served the request, in first-touch
      order; ``hops`` is ``len(engines) - 1``;
    * ``ttft_s`` -- admit-start to first generated token (needs a
      ``first_token`` / ``sim.first_token`` instant);
    * ``tpot_series`` -- ``(t_end, seconds_per_token)`` per decode
      dispatch the request was live in (sim: one entry per decode span);
    * ``pages_touched`` -- high-water page count seen in any of the
      request's span args.
    """

    request_id: int
    spans: List[Span] = dataclasses.field(default_factory=list)
    instants: List[Instant] = dataclasses.field(default_factory=list)

    # -- derived --------------------------------------------------------
    @property
    def engines(self) -> Tuple[str, ...]:
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(_engine_of(s.track))
        for e in self.instants:
            seen.setdefault(_engine_of(e.track))
        return tuple(seen)

    @property
    def hops(self) -> int:
        return max(len(self.engines) - 1, 0)

    @property
    def t_admit(self) -> Optional[float]:
        for s in self.spans:
            if s.name in ("admit", "sim.prefill"):
                return s.t0
        return None

    @property
    def t_first_token(self) -> Optional[float]:
        for e in self.instants:
            if e.name in ("first_token", "sim.first_token"):
                return e.t
        return None

    @property
    def t_retire(self) -> Optional[float]:
        for e in reversed(self.instants):
            if e.name == "retire":
                return e.t
        for s in reversed(self.spans):
            if s.name == "sim.decode":
                return s.t1
        return None

    @property
    def ttft_s(self) -> Optional[float]:
        t0, t1 = self.t_admit, self.t_first_token
        if t0 is None or t1 is None:
            return None
        return t1 - t0

    @property
    def tpot_series(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for s in self.spans:
            if s.name == "decode.dispatch":
                steps = int(s.args.get("n_steps", 1)) or 1
                out.append((s.t1, s.duration_s / steps))
            elif s.name == "sim.decode":
                gen = int(s.args.get("gen_len", 1)) or 1
                out.append((s.t1, s.duration_s / gen))
        return out

    @property
    def tpot_mean_s(self) -> Optional[float]:
        series = self.tpot_series
        if not series:
            return None
        return sum(v for _, v in series) / len(series)

    @property
    def pages_touched(self) -> int:
        pages = 0
        for s in self.spans:
            for key in ("n_pages", "pages"):
                v = s.args.get(key)
                if isinstance(v, (int, float)):
                    pages = max(pages, int(v))
        return pages

    # -- completeness ---------------------------------------------------
    def gaps(self) -> List[str]:
        """Reasons this timeline is NOT gap-free (empty == complete).

        Gap-free means: the request was admitted, produced a first
        token, retired, every evict has a matching restore (migration
        hops included), and no decode work precedes admission.
        """
        issues: List[str] = []
        if self.t_admit is None:
            issues.append("no admit/prefill span")
        if self.t_first_token is None:
            issues.append("no first_token instant")
        if self.t_retire is None:
            issues.append("no retire record")
        evicts = sum(1 for s in self.spans if s.name == "preempt.evict")
        restores = sum(1 for s in self.spans
                       if s.name == "preempt.restore")
        # a crash migration restores a HOST-HELD checkpoint on the
        # survivor with no matching evict span (the board died before
        # it could checkpoint), so each engine hop may add one
        # unmatched restore; anything beyond that -- or an evict that
        # never came back -- is a genuine gap
        if evicts > restores or restores > evicts + self.hops:
            issues.append(f"evict/restore imbalance ({evicts} evicts, "
                          f"{restores} restores, {self.hops} hops)")
        if self.t_admit is not None:
            early = [s.name for s in self.spans
                     if s.name in ("decode.dispatch", "sim.decode")
                     and s.t1 < self.t_admit]
            if early:
                issues.append(f"decode before admission: {early}")
        return issues

    @property
    def complete(self) -> bool:
        return not self.gaps()

    def as_dict(self) -> Dict[str, object]:
        """JSON-friendly summary (the request-timeline schema the docs
        catalog and ``repro_torch.obs.dump`` renders)."""
        return {
            "request_id": self.request_id,
            "engines": list(self.engines),
            "hops": self.hops,
            "t_admit": self.t_admit,
            "t_first_token": self.t_first_token,
            "t_retire": self.t_retire,
            "ttft_s": self.ttft_s,
            "tpot_mean_s": self.tpot_mean_s,
            "n_decode_dispatches": sum(
                1 for s in self.spans
                if s.name in ("decode.dispatch", "sim.decode")),
            "pages_touched": self.pages_touched,
            "complete": self.complete,
            "gaps": self.gaps(),
        }

    # -- construction ---------------------------------------------------
    @classmethod
    def from_tracer(cls, tracer_or_spans, request_id: int,
                    instants: Optional[Sequence[Instant]] = None
                    ) -> "RequestTimeline":
        """Select and order the records belonging to ``request_id``.

        Accepts a :class:`SpanTracer` or an explicit span list (plus
        ``instants``).  A span belongs to the request when its args
        carry ``uid == request_id`` or a ``uids`` batch containing it.
        """
        if isinstance(tracer_or_spans, SpanTracer):
            spans = tracer_or_spans.spans
            instants = tracer_or_spans.instants
        else:
            spans = list(tracer_or_spans)
            instants = list(instants or [])
        mine_s = sorted((s for s in spans
                         if request_id in _span_uids(s.args)),
                        key=lambda s: (s.t0, s.t1))
        mine_i = sorted((e for e in instants
                         if request_id in _span_uids(e.args)),
                        key=lambda e: e.t)
        return cls(request_id=request_id, spans=mine_s, instants=mine_i)


def request_ids(tracer: SpanTracer) -> List[int]:
    """Every request uid the tracer saw, sorted."""
    seen: set = set()
    for s in tracer.spans:
        seen.update(_span_uids(s.args))
    for e in tracer.instants:
        seen.update(_span_uids(e.args))
    return sorted(seen)


def request_timelines(tracer: SpanTracer) -> Dict[int, RequestTimeline]:
    """One :class:`RequestTimeline` per uid the tracer saw."""
    return {uid: RequestTimeline.from_tracer(tracer, uid)
            for uid in request_ids(tracer)}


def export_request_tracks(timelines: Dict[int, RequestTimeline]
                          ) -> Dict[str, object]:
    """Chrome-trace JSON with ONE track per request (``req/<uid>``).

    The same Perfetto schema ``SpanTracer.export_chrome_trace`` emits;
    each event keeps its original engine track in ``args["src_track"]``
    so the hop is readable from the viewer.  Batch-scoped spans appear
    on every member request's track.
    """
    out = SpanTracer(enabled=True)
    for uid in sorted(timelines):
        tl = timelines[uid]
        track = f"req/{uid}"
        for s in tl.spans:
            args = {k: v for k, v in s.args.items() if k != "src_track"}
            out.add_span(s.name, s.t0, s.t1, track=track,
                         src_track=s.track, **args)
        for e in tl.instants:
            args = {k: v for k, v in e.args.items() if k != "src_track"}
            out.add_instant(e.name, e.t, track=track,
                            src_track=e.track, **args)
    return out.export_chrome_trace()


def save_request_tracks(timelines: Dict[int, RequestTimeline],
                        path: str) -> None:
    with open(path, "w") as f:
        json.dump(export_request_tracks(timelines), f, indent=2)


def spans_from_chrome(obj: Dict[str, object]
                      ) -> Tuple[List[Span], List[Instant]]:
    """Invert :meth:`SpanTracer.export_chrome_trace`.

    Timestamps come back in SECONDS relative to the export's own base
    (the exporter subtracts it), so re-derived durations are exact but
    absolute times are trace-relative.
    """
    track_of: Dict[int, str] = {}
    for e in obj["traceEvents"]:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            track_of[e["tid"]] = e["args"]["name"]
    spans: List[Span] = []
    instants: List[Instant] = []
    for e in obj["traceEvents"]:
        track = track_of.get(e.get("tid"), str(e.get("tid")))
        if e.get("ph") == "X":
            t0 = e["ts"] / 1e6
            spans.append(Span(name=e["name"], track=track, t0=t0,
                              t1=t0 + e["dur"] / 1e6,
                              args=dict(e.get("args", {}))))
        elif e.get("ph") == "i":
            instants.append(Instant(name=e["name"], track=track,
                                    t=e["ts"] / 1e6,
                                    args=dict(e.get("args", {}))))
    return spans, instants
