"""Terminal summaries for the stack's trace artifacts.

One entry point over the three file shapes the serving stack writes::

    python -m repro_torch.obs.dump trace.json          # Chrome trace
    python -m repro_torch.obs.dump flight_serve.jsonl  # flight recorder
    python -m repro_torch.obs.dump pages.jsonl         # page op-stream

The shape is sniffed from the content, not the filename: a JSON object
with ``traceEvents`` is a Chrome trace (summarized as a per-request
TTFT/tpot table via :mod:`repro_torch.obs.requests`), a JSONL whose
header carries ``flight`` is a flight-recorder dump (header + last-N
tail), and a JSONL of ``op`` records is a page-lifecycle stream (the
sanitizer's event log).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.requests import RequestTimeline, spans_from_chrome

__all__ = ["sniff", "summarize_trace", "summarize_flight",
           "summarize_pages", "main"]

_TAIL_N = 10


def sniff(path: str) -> str:
    """``"trace"`` / ``"flight"`` / ``"pages"`` / ``"unknown"``."""
    with open(path) as f:
        head = f.read(1 << 20)
    try:
        obj = json.loads(head)
        if isinstance(obj, dict) and "traceEvents" in obj:
            return "trace"
    except ValueError:
        pass
    first = head.splitlines()[0] if head.strip() else ""
    try:
        rec = json.loads(first)
    except ValueError:
        return "unknown"
    if isinstance(rec, dict) and "flight" in rec:
        return "flight"
    if isinstance(rec, dict) and "op" in rec:
        return "pages"
    return "unknown"


def _fmt(v: Optional[float], scale: float = 1e3,
         unit: str = "ms") -> str:
    return "-" if v is None else f"{v * scale:.2f}{unit}"


def summarize_trace(path: str) -> List[str]:
    with open(path) as f:
        obj = json.load(f)
    spans, instants = spans_from_chrome(obj)
    uids = sorted({u for s in spans
                   for u in _uids_of(s.args)}
                  | {u for e in instants for u in _uids_of(e.args)})
    lines = [f"{path}: chrome trace, {len(spans)} spans, "
             f"{len(instants)} instants, {len(uids)} request(s)"]
    if not uids:
        return lines
    header = (f"{'uid':>5} {'engines':<18} {'hops':>4} {'ttft':>10} "
              f"{'tpot':>10} {'disp':>5} {'pages':>5} {'complete':>8}")
    lines.append(header)
    lines.append("-" * len(header))
    for uid in uids:
        tl = RequestTimeline.from_tracer(spans, uid, instants=instants)
        lines.append(
            f"{uid:>5} {','.join(tl.engines):<18} {tl.hops:>4} "
            f"{_fmt(tl.ttft_s):>10} {_fmt(tl.tpot_mean_s):>10} "
            f"{sum(1 for s in tl.spans if s.name in ('decode.dispatch', 'sim.decode')):>5} "
            f"{tl.pages_touched:>5} "
            f"{'yes' if tl.complete else 'NO':>8}")
        for gap in tl.gaps():
            lines.append(f"      ^ gap: {gap}")
    return lines


def _uids_of(args: Dict[str, Any]) -> List[int]:
    out = []
    if args.get("uid") is not None:
        out.append(int(args["uid"]))
    for u in args.get("uids") or ():
        out.append(int(u))
    return out


def summarize_flight(path: str, tail_n: int = _TAIL_N) -> List[str]:
    header, records = FlightRecorder.load(path)
    lines = [f"{path}: flight dump of engine "
             f"{header.get('flight', '?')!r}",
             f"  reason: {header.get('reason', '')}",
             f"  records: {header.get('n_records', len(records))} "
             f"(capacity {header.get('capacity', '?')}, "
             f"{header.get('n_dropped', 0)} dropped)"]
    kinds: Dict[str, int] = {}
    for rec in records:
        kinds[rec.get("kind", "?")] = kinds.get(rec.get("kind", "?"), 0) + 1
    lines.append("  by kind: " + ", ".join(
        f"{k}={n}" for k, n in sorted(kinds.items())))
    lines.append(f"  last {min(tail_n, len(records))} record(s):")
    for rec in records[-tail_n:]:
        kind = rec.get("kind", "?")
        if kind == "span":
            dur = (rec["t1"] - rec["t0"]) * 1e3
            lines.append(f"    span    {rec['name']:<24} "
                         f"{rec['track']:<16} {dur:8.2f}ms "
                         f"{rec.get('args', {})}")
        elif kind == "instant":
            lines.append(f"    instant {rec['name']:<24} "
                         f"{rec['track']:<16} {rec.get('args', {})}")
        elif kind == "event":
            lines.append(f"    event   {rec['name']:<24} "
                         f"{rec.get('fields', {})}")
        elif kind == "metrics":
            lines.append(f"    metrics snapshot "
                         f"({len(rec.get('values', {}))} series)")
        else:
            lines.append(f"    {kind} {rec}")
    return lines


def summarize_pages(path: str, tail_n: int = _TAIL_N) -> List[str]:
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    ops: Dict[str, int] = {}
    for rec in records:
        ops[rec.get("op", "?")] = ops.get(rec.get("op", "?"), 0) + 1
    lines = [f"{path}: page op-stream, {len(records)} record(s)",
             "  by op: " + ", ".join(
                 f"{k}={n}" for k, n in sorted(ops.items())),
             f"  last {min(tail_n, len(records))} record(s):"]
    for rec in records[-tail_n:]:
        lines.append("    " + json.dumps(rec))
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    status = 0
    for path in argv:
        kind = sniff(path)
        if kind == "trace":
            out = summarize_trace(path)
        elif kind == "flight":
            out = summarize_flight(path)
        elif kind == "pages":
            out = summarize_pages(path)
        else:
            out = [f"{path}: unrecognized trace artifact"]
            status = 1
        print("\n".join(out))
    return status


if __name__ == "__main__":
    sys.exit(main())
