"""repro_torch.obs: serving telemetry of the port.

The reference's ``obs`` package.  A typed :class:`MetricsRegistry`
every layer publishes into under one dot-namespaced schema, a
:class:`SpanTracer` wrapping the engine's hot-path boundaries (host
clock) with Chrome-trace/Perfetto and Prometheus-style exports, an
append-only :class:`EventLog` for validator verdicts, and a sim-to-real
calibration gate (:func:`predict_replay` / :func:`calibrate_replay`)
that fits the scheduling model against ``repro_torch.fleet.execution``
replays.

On top of those primitives: request-scoped timelines reconstructed
from the span stream (:class:`RequestTimeline`), a bounded
:class:`FlightRecorder` dumped at faulting ops, and an SLO burn-rate
control loop (:class:`BurnRateMonitor` / :class:`SLOController`)
closing the loop into the degradation ladder.
``repro_torch.obs.schema`` catalogs the full namespace;
``python -m repro_torch.obs.dump`` summarizes the artifacts.
"""

from repro_torch.obs.calibration import (
    GATED_METRICS,
    CalibrationReport,
    PredictedReplay,
    calibrate_replay,
    fit_dispatch_time_model,
    fit_linear,
    predict_replay,
    rel_err,
)
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
    "CalibrationReport",
    "Counter",
    "DEFAULT_LOG",
    "Event",
    "EventLog",
    "FlightRecorder",
    "GATED_METRICS",
    "Gauge",
    "Histogram",
    "Instant",
    "MetricsRegistry",
    "PredictedReplay",
    "RequestTimeline",
    "SLOController",
    "SLOObjective",
    "Span",
    "SpanTracer",
    "StatsView",
    "calibrate_replay",
    "emit",
    "export_request_tracks",
    "fit_dispatch_time_model",
    "fit_linear",
    "flight_guard",
    "predict_replay",
    "rel_err",
    "request_ids",
    "request_timelines",
    "save_request_tracks",
    "spans_from_chrome",
]
