"""Sim-to-real calibration: fit the phase model against real replays
(a copy of the reference's ``obs/calibration.py``).

The fleet simulator's phase model (``serving/phase_model.py`` /
``core/perf_model.py``) predicts what a board does, the
execution-backed replay
(:func:`repro_torch.fleet.execution.run_trace_on_engine`) measures what
the real engine actually did.  This module closes the loop in two parts:

* **Structural replay prediction** (:func:`predict_replay`): a pure-host
  mirror of ``ServeEngine.run``'s scheduling -- FIFO admission gated on
  lanes and page reservations, power-of-two-shrunk ``decode_n`` blocks,
  reserve-then-grow page mapping, boundary retirement.  It predicts the
  replay's dispatch counts, decode steps, generated tokens, page-pool
  high-water mark, and blocked-admission episodes WITHOUT running a
  model.
  :func:`calibrate_replay` diffs prediction against measurement and
  gates on relative error: drift between the simulator's scheduling
  model and the real allocator/dispatch trace fails loudly
  (``chip_smoke.py`` on the card), and a deliberately perturbed model
  (mis-modeled ``dispatch_n`` or page geometry) MUST fail -- that is
  the gate's self-test.
* **Host-time constant fitting** (:func:`fit_dispatch_time_model`):
  least-squares fit of per-dispatch span durations against block size,
  yielding the host overhead per dispatch and seconds per decode step
  the real engine exhibits -- the constants a host-aware
  :class:`~repro_torch.core.perf_model.InferencePerfModel` extension
  needs.
  These are *reported*, not gated: smoke configs on CPU say nothing
  about CMP 170HX silicon, but the fit wiring is identical when the
  replay runs on the real board.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def _bucket_len(n: int, floor: int = 8) -> int:
    """Smallest power-of-two >= n (>= floor) -- must mirror the engine."""
    b = floor
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass(frozen=True)
class PredictedReplay:
    """What the scheduling model says a trace replay will measure."""

    decode_dispatches: int
    decode_steps: int
    generated_tokens: int
    kv_pages_hwm: int
    kv_admit_blocked: int

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def predict_replay(trace: Sequence, *, n_lanes: int, max_len: int,
                   dispatch_n: int = 8, paged: bool = False,
                   page_size: int = 16, n_pages: Optional[int] = None,
                   bt_width: Optional[int] = None) -> PredictedReplay:
    """Predict a ``run_trace_on_engine`` replay's counters host-side.

    ``trace`` is any sequence with ``arrival_s`` / ``uid`` /
    ``prompt_len`` / ``gen_len`` fields (the fleet's
    :class:`~repro_torch.fleet.workload.FleetRequest`).  The model mirrors the
    engine's scheduling exactly for traces whose requests fit the cache
    (``prompt + gen + 1 <= max_len``, the replay regime): admission is
    FIFO over free lanes, gated on page reservations when ``paged``;
    each dispatch advances every live lane ``min(block, remaining)``
    tokens with the block shrunk to a power of two when all live lanes
    owe fewer; pages map reserve-then-grow and free at retirement.

    ``bt_width`` defaults to ``max_len // page_size`` (the non-sliding
    block-table width); pass the engine's value for window configs.
    """
    reqs = [(min(int(r.prompt_len), max_len - 1), int(r.gen_len), r.uid)
            for r in sorted(trace, key=lambda r: (r.arrival_s, r.uid))]
    if paged:
        bt = bt_width if bt_width is not None else max_len // page_size
        pool = n_lanes * bt if n_pages is None else int(n_pages)
    else:
        bt = pool = 0

    def pages(positions: int) -> int:
        if not paged or bt == 0:
            return 0
        return min(-(-int(positions) // page_size), bt)

    lane_rem = [0] * n_lanes          # 0 == free lane
    lane_len = [0] * n_lanes
    lane_mapped = [0] * n_lanes       # pages alloc'd to the lane
    lane_reserved = [0] * n_lanes     # promised but not yet mapped
    in_use = reserved = 0
    hwm = 0
    blocked_uids = set()
    dispatches = steps = generated = blocked = 0
    pending = list(reqs)
    live = 0

    def admit(plen: int, gen: int, uid) -> bool:
        nonlocal in_use, reserved, hwm, blocked, live
        free = [i for i in range(n_lanes) if lane_rem[i] == 0]
        if not free:
            return False
        lane = free[0]
        need = pages(min(plen + gen + 1, max_len))
        if paged:
            if need > pool - in_use - reserved:
                if uid not in blocked_uids:
                    blocked_uids.add(uid)
                    blocked += 1
                return False
            blocked_uids.discard(uid)
            reserved += need
            hwm = max(hwm, in_use + reserved)
            lane_reserved[lane] = need
            take = pages(plen + 1)
            lane_mapped[lane] = take
            lane_reserved[lane] -= take
            in_use += take
            reserved -= take
        lane_len[lane] = plen
        lane_rem[lane] = gen
        live += 1
        return True

    while pending or live:
        while pending and admit(*pending[0]):
            pending.pop(0)
        if live == 0:
            raise RuntimeError(
                "predicted replay livelocked: head request can never be "
                "admitted (mirror of ServeEngine.run's failure mode)")
        max_rem = max(r for r in lane_rem if r > 0)
        n = min(dispatch_n, _bucket_len(max_rem, floor=1))
        for i in range(n_lanes):
            if lane_rem[i] <= 0:
                continue
            gen = min(n, lane_rem[i])
            if paged:
                target = pages(lane_len[i] + gen + 1)
                grow = max(target - lane_mapped[i], 0)
                lane_mapped[i] += grow
                lane_reserved[i] -= grow
                in_use += grow
                reserved -= grow
            lane_rem[i] -= gen
            lane_len[i] += gen
            generated += gen
            if lane_rem[i] <= 0:                  # boundary retirement
                in_use -= lane_mapped[i]
                reserved -= lane_reserved[i]
                lane_mapped[i] = lane_reserved[i] = 0
                lane_len[i] = 0
                live -= 1
        dispatches += 1
        steps += n
    return PredictedReplay(decode_dispatches=dispatches,
                           decode_steps=steps,
                           generated_tokens=generated,
                           kv_pages_hwm=hwm,
                           kv_admit_blocked=blocked)


# ----------------------------------------------------------------------
# fit + gate
# ----------------------------------------------------------------------

def rel_err(sim: float, real: float) -> float:
    """|sim - real| / max(|real|, 1) -- counter-friendly relative error."""
    return abs(float(sim) - float(real)) / max(abs(float(real)), 1.0)


#: replay counters the drift gate checks (the acceptance contract:
#: dispatch counts and the page high-water mark must agree)
GATED_METRICS = ("decode_dispatches", "decode_steps",
                 "generated_tokens", "kv_pages_hwm")


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """Sim-vs-real diff plus fitted host-time constants."""

    tolerance: float
    #: metric -> {"real": measured, "sim": predicted, "rel_err": err}
    metrics: Dict[str, Dict[str, float]]
    #: least-squares host-time constants (reported, not gated)
    fitted: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def max_rel_err(self) -> float:
        return max((m["rel_err"] for m in self.metrics.values()),
                   default=0.0)

    @property
    def ok(self) -> bool:
        return self.max_rel_err <= self.tolerance

    def as_dict(self) -> Dict[str, object]:
        return {"tolerance": self.tolerance, "ok": self.ok,
                "max_rel_err": round(self.max_rel_err, 6),
                "metrics": self.metrics, "fitted": self.fitted}


def fit_linear(xs: Sequence[float],
               ys: Sequence[float]) -> Tuple[float, float]:
    """Least-squares ``y ~= a + b*x``; degenerate x collapses to mean."""
    import numpy as np

    x = np.asarray(xs, np.float64)
    y = np.asarray(ys, np.float64)
    assert x.size == y.size and x.size > 0
    if x.size == 1 or float(np.ptp(x)) == 0.0:
        return float(y.mean()), 0.0
    b, a = np.polyfit(x, y, 1)
    return float(a), float(b)


def fit_dispatch_time_model(spans: Iterable) -> Dict[str, float]:
    """Fit host-time constants from ``decode.dispatch`` span durations.

    ``duration ~= t_dispatch_overhead_s + n_steps * t_per_step_s`` over
    the spans' recorded block sizes -- the host-side analogue of the
    perf model's per-token decode step, measured instead of modeled.
    Returns an empty dict when no dispatch spans were recorded.
    """
    pts: List[Tuple[float, float]] = []
    for s in spans:
        if s.name == "decode.dispatch" and "n_steps" in s.args:
            pts.append((float(s.args["n_steps"]), s.duration_s))
    if not pts:
        return {}
    a, b = fit_linear([p[0] for p in pts], [p[1] for p in pts])
    return {"t_dispatch_overhead_s": a, "t_per_step_s": b,
            "n_spans": float(len(pts))}


def calibrate_replay(real, sim: PredictedReplay,
                     tolerance: float = 0.1,
                     spans: Optional[Iterable] = None,
                     gate_on: Sequence[str] = GATED_METRICS
                     ) -> CalibrationReport:
    """Diff a measured replay against the scheduling model's prediction.

    ``real`` is an :class:`~repro_torch.fleet.execution.ExecutionResult`
    (or anything with the gated counter attributes); ``sim`` comes from
    :func:`predict_replay`.  The report's ``ok`` is the bench-smoke
    drift gate: every gated counter's relative error within
    ``tolerance``.  ``spans`` (optional) adds the fitted host-time
    constants to the report.
    """
    pred = sim.as_dict()
    # ExecutionResult spells one counter differently
    real_attr = {"generated_tokens": "gen_tokens"}
    metrics = {}
    for key in gate_on:
        real_v = float(getattr(real, real_attr.get(key, key)))
        sim_v = float(pred[key])
        metrics[key] = {"real": real_v, "sim": sim_v,
                        "rel_err": round(rel_err(sim_v, real_v), 6)}
    fitted = fit_dispatch_time_model(spans) if spans is not None else {}
    return CalibrationReport(tolerance=tolerance, metrics=metrics,
                             fitted=fitted)
