"""Energy-efficiency and fleet-economics model (paper C5, §4.4 + Table 1-x),
copied from the reference for the port.

The paper's bottom line is an *economics* argument: hundreds of thousands
of mining boards (Table 1-2 estimates ~460k-640k units) with retained HBM
bandwidth are viable for bandwidth-bound inference if tokens/s/W and
tokens/s/$ are competitive.  This module turns
:class:`~repro_torch.core.perf_model.InferencePerfModel` phase estimates
into those two figures and reproduces the paper's sales-volume estimation
methodology (Appendix Ex.1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional

from repro_torch.core.device_profile import DeviceProfile, get_profile
from repro_torch.core.perf_model import (QWEN25_1P5B, InferencePerfModel,
                                         LLMSpec)


def capex_usd_per_hour(profile: DeviceProfile,
                       amortization_years: float = 3.0) -> float:
    """Board price amortized to $/hour (0 when no ASP is known)."""
    if not profile.asp_usd:
        return 0.0
    return profile.asp_usd / (amortization_years * 365 * 24)


def energy_usd_per_hour(watts: float,
                        power_usd_per_kwh: float = 0.10) -> float:
    return watts / 1000.0 * power_usd_per_kwh


@dataclasses.dataclass(frozen=True)
class EfficiencyReport:
    profile: str
    fmt: str
    phase: str
    tokens_per_s: float
    watts: float
    tokens_per_joule: float
    tokens_per_usd_hour: Optional[float]  # incl. capex amortization
    usd_per_mtok: Optional[float]


def efficiency(profile: DeviceProfile, fmt: str, phase: str = "decode",
               spec: LLMSpec = QWEN25_1P5B,
               power_usd_per_kwh: float = 0.10,
               amortization_years: float = 3.0) -> EfficiencyReport:
    """tokens/W and $/Mtok for one (device, format, phase) cell."""
    model = InferencePerfModel(profile, spec)
    est = model.decode(fmt) if phase == "decode" else model.prefill(fmt)
    tokens_per_usd_hour = None
    usd_per_mtok = None
    if profile.asp_usd is not None:
        usd_hour = (capex_usd_per_hour(profile, amortization_years)
                    + energy_usd_per_hour(est.watts, power_usd_per_kwh))
        tokens_per_usd_hour = est.tokens_per_s * 3600.0 / usd_hour
        usd_per_mtok = 1e6 / tokens_per_usd_hour
    return EfficiencyReport(
        profile=profile.name, fmt=fmt, phase=phase,
        tokens_per_s=est.tokens_per_s, watts=est.watts,
        tokens_per_joule=est.tokens_per_joule,
        tokens_per_usd_hour=tokens_per_usd_hour,
        usd_per_mtok=usd_per_mtok)


def efficiency_grid(profile_names: Iterable[str], fmts: Iterable[str],
                    phase: str = "decode") -> List[EfficiencyReport]:
    return [efficiency(get_profile(p), f, phase)
            for p in profile_names for f in fmts]


def request_energy_joules(profile: DeviceProfile, prompt_len: int,
                          gen_len: int, fmt: str,
                          spec: LLMSpec = QWEN25_1P5B,
                          phase: str = "both") -> float:
    """Joules to serve one request solo (``phase``: prefill/decode/both).

    The reference's fleet simulator (``fleet/node.py``) charges each
    request the solo cost of each phase *on the board that runs it* -- in a
    disaggregated fleet prefill and decode hit different device
    profiles.  Batched sharing of the streamed weights shows up in the
    node-level power integration instead, so the per-request figure
    stays comparable across load levels.
    """
    model = InferencePerfModel(profile, spec)
    joules = 0.0
    if phase in ("both", "prefill"):
        pre = model.prefill(fmt, prompt_len)
        joules += prompt_len / pre.tokens_per_joule
    if phase in ("both", "decode"):
        dec = model.decode(fmt, prompt_len + gen_len // 2)
        joules += gen_len / dec.tokens_per_joule
    return joules


# ----------------------------------------------------------------------
# Paper Table 1-1 / 1-2: CMP fleet sizing (Appendix Ex.1 methodology)
# ----------------------------------------------------------------------

#: Table 1-1: model -> (ASP midpoint $, FP16 TFLOPS).
CMP_LINEUP: Mapping[str, tuple] = {
    "cmp-30hx": (750.0, 10.05),
    "cmp-40hx": (650.0, 15.21),
    "cmp-50hx": (800.0, 22.15),
    "cmp-90hx": (1550.0, 21.89),
    "cmp-170hx": (4500.0, 50.53),
}

#: FY2022 crypto-related revenue (paper §1.1.1), USD.
FY2022_CMP_REVENUE = 550e6

#: Table 1-2 revenue-mix scenarios (fractions per model, paper order).
SCENARIOS: Mapping[str, tuple] = {
    "A": (0.15, 0.25, 0.25, 0.20, 0.15),
    "B": (0.25, 0.30, 0.20, 0.15, 0.10),
    "C": (0.10, 0.15, 0.20, 0.25, 0.30),
}


def estimate_sales(scenario: str,
                   revenue: float = FY2022_CMP_REVENUE) -> Dict[str, float]:
    """Units per model under a revenue-mix scenario (paper Table 1-2)."""
    mix = SCENARIOS[scenario]
    units: Dict[str, float] = {}
    for (name, (asp, _)), frac in zip(CMP_LINEUP.items(), mix):
        units[name] = revenue * frac / asp
    units["total"] = sum(units.values())
    return units


def stranded_fp16_tflops(scenario: str) -> float:
    """Aggregate stranded FP16 compute across the estimated fleet."""
    units = estimate_sales(scenario)
    return sum(units[name] * tf for name, (_, tf) in CMP_LINEUP.items())
