"""Heterogeneous prefill/decode disaggregation (paper SS6.2, operationalized).

The paper's recommendation -- use bandwidth-rich compute-poor boards for
the memory-bound phase -- becomes a fleet scheduler: given device pools
(e.g. a few A100s + many reclaimed CMP 170HXs), assign the compute-bound
prefill phase and the bandwidth-bound decode phase to the pools that
maximize served tokens/s (or minimize $/Mtok), with the KV handoff cost
modeled over the host interconnect.

This is an analytic *steady-state* scheduler; the shared per-phase
throughput/handoff/cost primitives live in `repro_torch.serving.phase_model`
so the trace-driven simulator (`repro_torch.fleet`) uses the exact same model
with queueing dynamics on top.  The execution half is
`repro_torch.serving.engine` on each pool.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Optional, Tuple

from repro_torch.core.device_profile import get_profile
from repro_torch.core.perf_model import LLMSpec, QWEN25_1P5B
from repro_torch.serving.phase_model import (Workload, capex_usd_per_hour,
                                       effective_prefill_tps,
                                       energy_usd_per_hour, phase_tps)

__all__ = ["Workload", "PoolAssignment", "FleetPlan", "plan_fleet",
           "homogeneous_baseline"]


@dataclasses.dataclass(frozen=True)
class PoolAssignment:
    profile: str
    count: int
    role: str                 # "prefill" | "decode" | "both"
    phase_tokens_per_s: float


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    assignments: Tuple[PoolAssignment, ...]
    prefill_tps: float
    decode_tps: float
    requests_per_s: float
    watts: float
    usd_per_hour: float
    usd_per_mtok: float


def plan_fleet(pools: Mapping[str, int], wl: Workload = Workload(),
               spec: LLMSpec = QWEN25_1P5B,
               power_usd_per_kwh: float = 0.10,
               amortization_years: float = 3.0) -> FleetPlan:
    """Choose per-pool roles maximizing sustained requests/s.

    Enumerates role assignments (each pool: prefill / decode / both) --
    the pool count is tiny so brute force is exact.
    """
    names = list(pools)
    best: Optional[FleetPlan] = None
    for roles in itertools.product(("prefill", "decode", "both"),
                                   repeat=len(names)):
        pre_tps = dec_tps = watts = usd_hour = 0.0
        assignments = []
        for name, role in zip(names, roles):
            prof = get_profile(name)
            n = pools[name]
            # a "prefill" board loses the KV handoff time per request
            eff_p, p_w = effective_prefill_tps(prof, wl, spec)
            d_tps, d_w = phase_tps(prof, wl, "decode", spec)
            if role == "prefill":
                pre_tps += n * eff_p
                watts += n * p_w
            elif role == "decode":
                dec_tps += n * d_tps
                watts += n * d_w
            else:  # both: split time between phases optimally (50/50 seed);
                # decode is colocated, the KV never leaves HBM -> no
                # handoff derating (same model as the simulator's
                # local-decode path)
                raw_p, _ = phase_tps(prof, wl, "prefill", spec)
                pre_tps += n * raw_p * 0.5
                dec_tps += n * d_tps * 0.5
                watts += n * (p_w + d_w) / 2
            usd_hour += n * capex_usd_per_hour(prof, amortization_years)
            assignments.append(PoolAssignment(
                profile=name, count=n, role=role,
                phase_tokens_per_s=eff_p if role == "prefill" else d_tps))
        usd_hour += energy_usd_per_hour(watts, power_usd_per_kwh)
        # steady state: requests/s limited by the slower phase
        req_s = min(pre_tps / max(wl.prompt_len, 1),
                    dec_tps / max(wl.gen_len, 1))
        if req_s <= 0:
            continue
        gen_tok_s = req_s * wl.gen_len
        plan = FleetPlan(
            assignments=tuple(assignments), prefill_tps=pre_tps,
            decode_tps=dec_tps, requests_per_s=req_s, watts=watts,
            usd_per_hour=usd_hour,
            usd_per_mtok=usd_hour / max(gen_tok_s * 3600 / 1e6, 1e-9))
        if best is None or plan.requests_per_s > best.requests_per_s:
            best = plan
    assert best is not None
    return best


def homogeneous_baseline(profile_name: str, count: int,
                         wl: Workload = Workload(),
                         spec: LLMSpec = QWEN25_1P5B) -> FleetPlan:
    """All boards run both phases -- the non-disaggregated reference."""
    return plan_fleet({profile_name: count}, wl, spec)
