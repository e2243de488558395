"""repro_torch.obs: serving telemetry of the port.

The reference's ``obs`` package without its calibration gate (which
fits the scheduling model against fleet replays the port does not have
yet).  A typed :class:`MetricsRegistry` every layer publishes into under
one dot-namespaced schema, a :class:`SpanTracer` wrapping the engine's
hot-path boundaries (host clock) with Chrome-trace/Perfetto and
Prometheus-style exports, and an append-only :class:`EventLog`.

On top of those primitives: request-scoped timelines reconstructed
from the span stream (:class:`RequestTimeline`), a bounded
:class:`FlightRecorder` dumped at faulting ops, and an SLO burn-rate
control loop (:class:`BurnRateMonitor` / :class:`SLOController`)
closing the loop into the degradation ladder.
``repro_torch.obs.schema`` catalogs the full namespace;
``python -m repro_torch.obs.dump`` summarizes the artifacts.
"""

from repro_torch.obs.events import DEFAULT_LOG, Event, EventLog, emit
from repro_torch.obs.flight import FlightRecorder, flight_guard
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StatsView,
)
from repro_torch.obs.requests import (
    RequestTimeline,
    export_request_tracks,
    request_ids,
    request_timelines,
    save_request_tracks,
    spans_from_chrome,
)
from repro_torch.obs.slo import BurnRateMonitor, SLOController, SLOObjective
from repro_torch.obs.trace import Instant, Span, SpanTracer

__all__ = [
    "BurnRateMonitor",
    "Counter",
    "DEFAULT_LOG",
    "Event",
    "EventLog",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "Instant",
    "MetricsRegistry",
    "RequestTimeline",
    "SLOController",
    "SLOObjective",
    "Span",
    "SpanTracer",
    "StatsView",
    "emit",
    "export_request_tracks",
    "flight_guard",
    "request_ids",
    "request_timelines",
    "save_request_tracks",
    "spans_from_chrome",
]
