"""Seeded request-trace generators for the fleet (a copy of the
reference's ``fleet/workload.py``: the same seed gives the same trace).

A trace is a time-ordered list of :class:`FleetRequest` arrivals.  All
randomness flows through one ``numpy.random.default_rng(seed)``, so a
given (generator, parameters, seed) triple is bit-reproducible -- the
property every simulator metric inherits.

Three arrival processes cover the serving regimes that matter:

* :func:`poisson_trace`   -- memoryless steady traffic (M/·/· baseline);
* :func:`bursty_trace`    -- ON/OFF modulated Poisson (flash crowds, the
  regime where disaggregated fleets earn their keep or fall over);
* :func:`diurnal_trace`   -- sinusoidal day/night rate (capacity-planning
  horizon, the autoscaler's target);
* :func:`constant_trace`  -- deterministic arrivals, used to validate the
  simulator's steady state against the analytic planner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class FleetRequest:
    """One inference request as the router sees it."""

    uid: int
    arrival_s: float
    prompt_len: int
    gen_len: int
    #: which registered model serves this request (None = single-model
    #: fleet, the pre-multimodel behavior)
    model_id: Optional[str] = None
    #: prompt-prefix family: requests sharing a ``prefix_id`` open with
    #: the same ``prefix_len`` tokens (system prompt / few-shot
    #: template).  None = unique prompt, the pre-prefix behavior.  A
    #: prefix-sharing engine/board serves the shared span from cached
    #: KV pages; capacity models discount it accordingly.
    prefix_id: Optional[int] = None
    prefix_len: int = 0


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Token-length distribution: lognormal around ``mean`` with
    coefficient of variation ``cv`` (``cv=0`` -> constant), clamped."""

    mean: int
    cv: float = 0.0
    min_len: int = 4
    max_len: int = 8192

    def sample(self, rng: np.random.Generator) -> int:
        if self.cv <= 0.0:
            return self.mean
        sigma2 = math.log(1.0 + self.cv ** 2)
        mu = math.log(self.mean) - sigma2 / 2.0
        x = rng.lognormal(mean=mu, sigma=math.sqrt(sigma2))
        return int(min(max(round(x), self.min_len), self.max_len))


def _emit(arrivals: List[float], rng: np.random.Generator,
          prompt: LengthDist, gen: LengthDist) -> List[FleetRequest]:
    return [FleetRequest(uid=i, arrival_s=t,
                         prompt_len=prompt.sample(rng),
                         gen_len=gen.sample(rng))
            for i, t in enumerate(arrivals)]


def poisson_trace(rate_rps: float, duration_s: float, seed: int = 0,
                  prompt: LengthDist = LengthDist(512),
                  gen: LengthDist = LengthDist(128)) -> List[FleetRequest]:
    """Homogeneous Poisson arrivals at ``rate_rps`` for ``duration_s``."""
    rng = np.random.default_rng(seed)
    arrivals, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate_rps)
        if t >= duration_s:
            break
        arrivals.append(t)
    return _emit(arrivals, rng, prompt, gen)


def bursty_trace(rate_on_rps: float, duration_s: float, seed: int = 0,
                 rate_off_rps: Optional[float] = None,
                 mean_on_s: float = 10.0, mean_off_s: float = 20.0,
                 prompt: LengthDist = LengthDist(512),
                 gen: LengthDist = LengthDist(128)) -> List[FleetRequest]:
    """ON/OFF (interrupted Poisson) arrivals.

    The process alternates exponential ON periods (rate ``rate_on_rps``)
    and OFF periods (rate ``rate_off_rps``, default ``rate_on/10``) --
    the bursty regime where queueing, not steady-state throughput,
    decides the tail latency.
    """
    if rate_off_rps is None:
        rate_off_rps = rate_on_rps / 10.0
    rng = np.random.default_rng(seed)
    arrivals: List[float] = []
    t, on = 0.0, True
    phase_end = rng.exponential(mean_on_s)
    while t < duration_s:
        rate = rate_on_rps if on else rate_off_rps
        if rate > 0:
            nxt = t + rng.exponential(1.0 / rate)
            if nxt < phase_end:
                t = nxt
                if t < duration_s:
                    arrivals.append(t)
                continue
        # no arrival before the phase flips (memoryless: restart there)
        t = phase_end
        on = not on
        phase_end = t + rng.exponential(mean_on_s if on else mean_off_s)
    return _emit(arrivals, rng, prompt, gen)


def diurnal_trace(base_rps: float, peak_rps: float, duration_s: float,
                  seed: int = 0, period_s: float = 86400.0,
                  prompt: LengthDist = LengthDist(512),
                  gen: LengthDist = LengthDist(128)) -> List[FleetRequest]:
    """Inhomogeneous Poisson with a sinusoidal day/night rate.

    Sampled by thinning a homogeneous ``peak_rps`` process; the
    instantaneous rate swings between ``base_rps`` (trough) and
    ``peak_rps`` (crest) once per ``period_s``.
    """
    assert peak_rps >= base_rps > 0
    rng = np.random.default_rng(seed)
    arrivals, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / peak_rps)
        if t >= duration_s:
            break
        mid = (base_rps + peak_rps) / 2.0
        amp = (peak_rps - base_rps) / 2.0
        rate = mid + amp * math.sin(2.0 * math.pi * t / period_s)
        if rng.uniform() < rate / peak_rps:
            arrivals.append(t)
    return _emit(arrivals, rng, prompt, gen)


def multimodel_trace(trace: List[FleetRequest], mix: dict,
                     seed: int = 0) -> List[FleetRequest]:
    """Assign a ``model_id`` to every request of ``trace`` by weighted
    draw -- the multi-model request mix.

    ``mix`` maps model id -> weight (normalized internally); the draw
    is seeded separately from the arrival process so the same arrival
    trace can be replayed under different mixes.  Composes with every
    generator above::

        trace = multimodel_trace(poisson_trace(3.0, 60.0, seed=0),
                                 {"qwen2.5-1.5b": 2, "qwen2.5-0.5b": 1},
                                 seed=1)
    """
    assert mix and all(w > 0 for w in mix.values()), mix
    ids = sorted(mix)
    weights = np.asarray([mix[i] for i in ids], np.float64)
    weights = weights / weights.sum()
    rng = np.random.default_rng(seed)
    draws = rng.choice(len(ids), size=len(trace), p=weights)
    return [dataclasses.replace(r, model_id=ids[d])
            for r, d in zip(trace, draws)]


def shared_prefix_trace(trace: List[FleetRequest], prefix_len: int = 256,
                        fanout: int = 4, n_prefixes: Optional[int] = None,
                        seed: int = 0) -> List[FleetRequest]:
    """Overlay a shared-prefix structure on an arrival ``trace``: each
    request joins one of the prompt-prefix families (system prompts /
    few-shot templates) and its prompt OPENS with that family's
    ``prefix_len`` common tokens, followed by a unique tail.

    * ``fanout`` -- mean requests per prefix family (the reuse degree);
      ``n_prefixes`` overrides it with a fixed family count;
    * prompts shorter than ``prefix_len + 1`` are lengthened to hold
      the prefix plus at least one unique tail token (a real serving
      stack never sees a prompt that is ONLY the cached template);
    * the family draw is seeded separately from the arrival process so
      the same arrivals replay under different sharing structures.

    The *overlap fraction* -- the knob the prefix bench sweeps -- is
    ``prefix_len / mean_prompt_len``.  Composes with every generator in
    this module, like :func:`multimodel_trace`::

        trace = shared_prefix_trace(poisson_trace(3.0, 60.0, seed=0),
                                    prefix_len=256, fanout=8, seed=1)
    """
    assert prefix_len > 0 and fanout >= 1
    if not trace:
        return []
    k = n_prefixes if n_prefixes is not None \
        else max(int(round(len(trace) / fanout)), 1)
    rng = np.random.default_rng(seed)
    fams = rng.integers(0, k, size=len(trace))
    return [dataclasses.replace(
                r, prefix_id=int(f), prefix_len=prefix_len,
                prompt_len=max(r.prompt_len, prefix_len + 1))
            for r, f in zip(trace, fams)]


def constant_trace(rate_rps: float, duration_s: float,
                   prompt_len: int = 512,
                   gen_len: int = 128) -> List[FleetRequest]:
    """Deterministic arrivals every ``1/rate`` s with fixed lengths --
    the steady-state fixture for validating against ``plan_fleet``."""
    n = int(rate_rps * duration_s)
    return [FleetRequest(uid=i, arrival_s=(i + 1) / rate_rps,
                         prompt_len=prompt_len, gen_len=gen_len)
            for i in range(n)]
