"""Shared phase-throughput model for fleet planning and simulation,
copied from the reference for the port.

Both the reference's *static* steady-state planner
(``serving/disaggregation.py``) and its *dynamic* trace-driven
simulator (``fleet``) need the same primitives: what a device pool
sustains in each serving phase, what the prefill->decode KV handoff
costs over the board's host link, and how a board's price amortizes
into $/hour.  In the port, the multi-model pool
(:mod:`repro_torch.serving.modelpool`) prices its weight swaps with
:func:`link_transfer_seconds`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.device_profile import DeviceProfile
from repro_torch.core.energy import (capex_usd_per_hour,
                                     energy_usd_per_hour)
from repro_torch.core.perf_model import (QWEN25_1P5B, InferencePerfModel,
                                         LLMSpec)

__all__ = ["Workload", "phase_tps", "kv_handoff_seconds",
           "link_transfer_seconds", "effective_prefill_tps",
           "capex_usd_per_hour", "energy_usd_per_hour"]


@dataclasses.dataclass(frozen=True)
class Workload:
    """A serving workload cell: prompt/gen lengths and weight format."""

    prompt_len: int = 512
    gen_len: int = 128
    fmt: str = "q8_0"


def phase_tps(profile: DeviceProfile, wl: Workload, phase: str,
              spec: LLMSpec = QWEN25_1P5B) -> Tuple[float, float]:
    """(tokens/s, watts) of one board running ``phase`` on ``wl``.

    Decode is evaluated at the mid-generation context
    (``prompt + gen/2``), matching the planner's steady-state view.
    """
    m = InferencePerfModel(profile, spec)
    est = (m.prefill(wl.fmt, wl.prompt_len) if phase == "prefill"
           else m.decode(wl.fmt, wl.prompt_len + wl.gen_len // 2))
    return est.tokens_per_s, est.watts


def link_transfer_seconds(profile: DeviceProfile, nbytes: float,
                          peer: DeviceProfile | None = None) -> float:
    """Seconds to move ``nbytes`` over the board's host link,
    bottlenecked by the slower endpoint when ``peer`` is given.

    This is the ONE transfer model every byte crossing a board boundary
    goes through -- prefill KV handoffs, preemption page migrations,
    and multi-model weight swaps all price against the same PCIe 1.1 x4
    (~1 GB/s) constraint on the CMP 170HX.
    """
    gbps = profile.total_interconnect_gbps()
    if peer is not None:
        gbps = min(gbps, peer.total_interconnect_gbps())
    return nbytes / (gbps * 1e9)


def kv_handoff_seconds(profile: DeviceProfile, prompt_len: int,
                       spec: LLMSpec = QWEN25_1P5B,
                       peer: DeviceProfile | None = None) -> float:
    """Prefill->decode KV transfer time over the host link.

    The transfer is bottlenecked by the slower endpoint when ``peer``
    (the decode-side board) is given -- for the CMP 170HX the PCIe 1.1
    x4 link (~1 GB/s) dominates either way.
    """
    return link_transfer_seconds(
        profile, spec.kv_bytes_per_token() * prompt_len, peer=peer)


def effective_prefill_tps(profile: DeviceProfile, wl: Workload,
                          spec: LLMSpec = QWEN25_1P5B) -> Tuple[float, float]:
    """Prefill tokens/s net of the per-request KV handoff, plus watts.

    A prefill board spends ``prompt/tps + handoff`` per request: the KV
    lives in its HBM until shipped, so the handoff is charged to the
    board's occupancy.  Equivalent to a throughput derating of
    ``1 / (1 + handoff * tps / prompt)``.
    """
    p_tps, p_w = phase_tps(profile, wl, "prefill", spec)
    handoff = kv_handoff_seconds(profile, wl.prompt_len, spec)
    return p_tps / (1.0 + handoff * p_tps / max(wl.prompt_len, 1)), p_w


