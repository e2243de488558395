"""Typed metrics registry: one namespaced schema for serving telemetry.

A copy of the reference's ``obs/metrics.py``.  Three typed instruments
under one dot-namespaced schema (``serve.decode.dispatches``,
``serve.pool.pages.in_use``, ...):

* :class:`Counter` -- monotone event count (resettable for bench reuse);
* :class:`Gauge` -- point-in-time value, either set explicitly or read
  live through a zero-cost callback (``fn=``) so hot paths never pay a
  publish (the page pool's occupancy gauges work this way);
* :class:`Histogram` -- value distribution with exact percentiles (span
  durations are few and host-side, so raw samples are kept rather than
  bucketed).

Exports: :meth:`MetricsRegistry.collect` (plain dict, JSON-friendly)
and :meth:`MetricsRegistry.to_prometheus` (text exposition, counters /
gauges / summaries with p50/p99 quantiles).

:class:`StatsView` is a ``MutableMapping`` facade that maps the flat
stats-dict keys onto registry instruments, so
``engine.stats["decode_dispatches"] += 1``, ``dict(engine.stats)``,
equality against a plain dict, and the bench's counter-reset idiom
(``engine.stats = {k: 0 for k in engine.stats}``) all work while the
values live in the registry.

Standard library only.
"""

from __future__ import annotations

import math
import re
from collections.abc import MutableMapping
from typing import Callable, Dict, Iterator, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotone count of events (resettable so benches can re-zero)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value: Number = 0

    @property
    def value(self) -> Number:
        return self._value

    def inc(self, n: Number = 1) -> None:
        self._value += n

    def set(self, v: Number) -> None:
        """Direct write -- the StatsView compat path and bench resets."""
        self._value = v


class Gauge:
    """Point-in-time value; ``fn`` makes it a live read-through gauge."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], Number]] = None):
        self.name = name
        self.help = help
        self._fn = fn
        self._value: Number = 0

    @property
    def value(self) -> Number:
        return self._fn() if self._fn is not None else self._value

    def set(self, v: Number) -> None:
        assert self._fn is None, f"{self.name} is a callback gauge"
        self._value = v

    def set_max(self, v: Number) -> None:
        assert self._fn is None, f"{self.name} is a callback gauge"
        self._value = max(self._value, v)


class Histogram:
    """Distribution with exact percentiles over the raw samples."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.samples: List[float] = []

    def observe(self, v: Number) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    def percentile(self, q: float) -> float:
        """Exact percentile (linear interpolation); NaN when empty."""
        if not self.samples:
            return float("nan")
        xs = sorted(self.samples)
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum,
                "p50": self.percentile(50), "p99": self.percentile(99)}


Metric = Union[Counter, Gauge, Histogram]


def _prom_name(name: str) -> str:
    """Dots and other separators become underscores (Prometheus rules)."""
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    Names are dot-namespaced (``layer.subsystem.metric``); re-requesting
    a name returns the existing instrument (and asserts the kind
    matches), so publishers can be wired independently.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        else:
            assert isinstance(m, cls), (
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], Number]] = None) -> Gauge:
        g = self._metrics.get(name)
        if g is None:
            g = Gauge(name, help=help, fn=fn)
            self._metrics[name] = g
        else:
            assert isinstance(g, Gauge), (
                f"metric {name!r} already registered as {g.kind}")
            if fn is not None:
                g._fn = fn
        return g

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(name, Histogram, help=help)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def sum_prefix(self, prefix: str) -> float:
        """Sum of every counter/gauge value under a dotted ``prefix``
        (e.g. ``serve.prefix`` aggregates the sharing counters) --
        histograms are skipped, they have no single value."""
        dotted = prefix if prefix.endswith(".") else prefix + "."
        total = 0.0
        for name in self.names():
            if name.startswith(dotted) and not isinstance(
                    self._metrics[name], Histogram):
                total += float(self._metrics[name].value)
        return total

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]

    def collect(self) -> Dict[str, object]:
        """Snapshot every instrument into a JSON-friendly dict
        (histograms fold to count/sum/p50/p99)."""
        out: Dict[str, object] = {}
        for name in self.names():
            m = self._metrics[name]
            out[name] = (m.summary() if isinstance(m, Histogram)
                         else m.value)
        return out

    def to_prometheus(self) -> str:
        """Text exposition: counters, gauges, and summary quantiles."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            pn = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {pn} summary")
                lines.append(f'{pn}{{quantile="0.5"}} {m.percentile(50)}')
                lines.append(f'{pn}{{quantile="0.99"}} {m.percentile(99)}')
                lines.append(f"{pn}_sum {m.sum}")
                lines.append(f"{pn}_count {m.count}")
            else:
                lines.append(f"# TYPE {pn} {m.kind}")
                lines.append(f"{pn} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")


class StatsView(MutableMapping):
    """Legacy stats-dict facade over registry instruments.

    Maps old flat keys (``"decode_dispatches"``) to registered counters
    / gauges so existing call sites -- ``stats[k] += 1``, ``dict(stats)``,
    ``stats == {...}``, ``stats.items()`` -- keep working unchanged.
    New keys cannot be invented through the view (the schema is the
    registry's), which is what makes the namespace authoritative.
    """

    def __init__(self, registry: MetricsRegistry,
                 keymap: Dict[str, str]):
        self._registry = registry
        self._keymap = dict(keymap)

    def metric(self, key: str) -> Metric:
        return self._registry[self._keymap[key]]

    def metric_name(self, key: str) -> str:
        return self._keymap[key]

    def __getitem__(self, key: str) -> Number:
        return self.metric(key).value

    def __setitem__(self, key: str, value: Number) -> None:
        if key not in self._keymap:
            raise KeyError(
                f"{key!r} is not in the telemetry schema; register it "
                "in the engine's keymap instead of inventing dict keys")
        self.metric(key).set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("telemetry schema keys cannot be deleted")

    def __iter__(self) -> Iterator[str]:
        return iter(self._keymap)

    def __len__(self) -> int:
        return len(self._keymap)

    def __eq__(self, other) -> bool:
        if isinstance(other, (dict, StatsView)):
            return dict(self) == dict(other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self) -> str:  # pragma: no cover
        return f"StatsView({dict(self)!r})"
