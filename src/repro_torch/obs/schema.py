"""The observability namespace, declared in one place.

The reference's ``obs/schema.py`` catalog, name for name: every span,
instant, event, and metric name the serving stack emits, plus the
request-timeline schema keys
(:meth:`~repro_torch.obs.requests.RequestTimeline.as_dict`).  The names
of the simulated fleet (``sim.*``), the model pool (``weights.swap``)
and the validators stay in the catalog so one document,
``docs/observability.md``, covers both packages; the port emits the
serving engine's names.  ``repro_torch.obs.dump`` uses the catalogs to
classify records when it summarizes a trace/flight/pages file.

Names with a ``<engine>`` / ``<model>`` placeholder are PREFIX
families: the live name substitutes the engine or model id (e.g.
``serve.decode_dispatches``, ``node0.pool.pages.free``).
"""

from __future__ import annotations

from typing import Dict, List

__all__ = [
    "SPAN_NAMES",
    "INSTANT_NAMES",
    "EVENT_NAMES",
    "METRIC_FAMILIES",
    "TIMELINE_KEYS",
    "FLIGHT_RECORD_KINDS",
    "all_names",
]

#: closed intervals on engine/lane/board tracks
SPAN_NAMES: Dict[str, str] = {
    "admit": "one admission: prefill + lane/page setup (uid)",
    "prefill.bucket": "batched prefill at a padded bucket length",
    "prefix.tail_prefill": "prefix-hit tail streamed through decode",
    "prefix.cow": "copy-on-write split of a shared page",
    "decode.dispatch": "one multi-step jitted decode dispatch "
                       "(n_steps, n_live, uids)",
    "preempt.evict": "lane checkpointed off the board (uid, n_pages)",
    "preempt.restore": "checkpoint scattered back onto a lane "
                       "(uid, n_pages)",
    "weights.swap": "model-pool weight swap on the serving engine",
    "sim.prefill": "simulated prefill residency (uid, prompt_len)",
    "sim.decode": "simulated decode residency (uid, gen_len)",
    "sim.swap": "simulated model swap",
    "sim.migrate": "simulated checkpoint migration (uid, pages, dst)",
    "sim.recover": "simulated crash-recovery transfer",
    "sim.fault.derate": "injected thermal derate window",
    "sim.fault.link": "injected host-link degradation window",
    "sim.fault.transient": "injected dispatch stall window",
}

#: zero-duration markers
INSTANT_NAMES: Dict[str, str] = {
    "admit.blocked": "admission refused for pages (uid, need_pages)",
    "prefix.hit": "radix prompt-cache hit (uid, matched_tokens)",
    "first_token": "first generated token surfaced host-side (uid)",
    "retire": "request completed and lane released (uid, gen)",
    "degrade.shed": "ladder-driven eviction of a victim lane (uid)",
    "weights.swap.done": "model-pool swap completed",
    "sim.first_token": "simulated first token (uid)",
    "sim.request_lost": "retry budget exhausted, request dropped (uid)",
    "sim.straggler_detected": "derate flagged by the straggler monitor",
    "sim.fault.crash": "injected fail-stop board crash",
}

#: structured events on the shared EventLog
EVENT_NAMES: Dict[str, str] = {
    "degrade.transition": "degradation-ladder level change",
    "slo.alert": "multi-window burn-rate alert fired",
    "slo.clear": "burn-rate alert cleared (short window recovered)",
    "slo.escalate": "SLO controller escalated the ladder",
    "slo.deescalate": "SLO controller de-escalated the ladder",
    "validate.preemption_exactness": "preemption exactness verdict",
    "validate.recovery_exactness": "crash-recovery exactness verdict",
    "validate.multimodel_exactness": "multi-model exactness verdict",
}

#: metric-name families (prefixes substitute the engine/pool name)
METRIC_FAMILIES: Dict[str, str] = {
    "<engine>.*": "ServeEngine counters (STATS_SCHEMA legacy keys)",
    "<engine>.pool.pages.*": "page-pool gauges (free, in_use, reserved, "
                             "disabled, hwm, allocs, frees, shared, "
                             "cow_splits)",
    "<engine>.prefix.cached_pages": "pages the radix prompt cache holds",
    "modelpool.*": "weight-pool gauges (bytes.used, bytes.free, "
                   "residents)",
    "fleet.*": "fleet-sim gauges and fault counters (retry.attempts, "
               "retry.hedges, faults.requests_lost)",
    "slo.*": "burn-rate gauges (burn_rate.short, burn_rate.long) and "
             "counters (violations.ttft, violations.tpot, alerts)",
    "span.<name>.seconds": "per-span duration histograms",
}

#: keys of RequestTimeline.as_dict() -- the request-timeline schema
TIMELINE_KEYS: List[str] = [
    "request_id", "engines", "hops", "t_admit", "t_first_token",
    "t_retire", "ttft_s", "tpot_mean_s", "n_decode_dispatches",
    "pages_touched", "complete", "gaps",
]

#: record kinds inside a flight_<engine>.jsonl dump
FLIGHT_RECORD_KINDS: List[str] = ["span", "instant", "event", "metrics"]


def all_names() -> List[str]:
    """Every declared name, for the docs snapshot test."""
    return (sorted(SPAN_NAMES) + sorted(INSTANT_NAMES)
            + sorted(EVENT_NAMES) + sorted(METRIC_FAMILIES)
            + TIMELINE_KEYS + FLIGHT_RECORD_KINDS)
