"""Three-term roofline analysis from compiled dry-run artifacts.

For every (architecture x shape x mesh) cell the dry-run records
``cost_analysis()`` FLOPs/bytes and HLO-parsed collective bytes; this
module converts them into the three roofline terms

    compute    = HLO_FLOPs      / (chips x peak_FLOP/s)
    memory     = HLO_bytes      / (chips x HBM_bw)
    collective = collective_B   / (chips x link_bw)

identifies the dominant term, and computes the model-FLOPs utilization
ratio (6ND / HLO_FLOPs) that exposes remat / redundancy waste.

Hardware constants default to the TPU v5e target (197 TFLOP/s bf16,
819 GB/s HBM, 50 GB/s/link ICI).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional

from repro_torch.core.device_profile import TPU_V5E, DeviceProfile


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Roofline decomposition of one compiled step on one mesh."""

    cell: str                   # "<arch>/<shape>/<mesh>"
    chips: int
    hlo_flops: float            # whole-step, all chips
    hlo_bytes: float
    collective_bytes: float
    model_flops: float          # 6*N*D (dense) or 6*N_active*D (MoE)
    t_compute_s: float
    t_memory_s: float
    t_collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute_s, "memory": self.t_memory_s,
                 "collective": self.t_collective_s}
        return max(terms, key=terms.get)

    @property
    def step_seconds(self) -> float:
        """No-overlap upper bound = dominant term under perfect overlap."""
        return max(self.t_compute_s, self.t_memory_s, self.t_collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs -- remat & redundancy waste detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline the step achieves, assuming
        perfect overlap: useful model FLOPs / (step_time x fleet peak)."""
        denom = self.step_seconds
        if denom <= 0:
            return 0.0
        return self.t_compute_s * self.useful_flops_ratio / denom

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant,
                 step_seconds=self.step_seconds,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def analyze(cell: str, chips: int, hlo_flops: float, hlo_bytes: float,
            collective_bytes: float, model_flops: float,
            profile: DeviceProfile = TPU_V5E,
            peak_tflops: Optional[float] = None) -> RooflineTerms:
    """Build roofline terms for one cell.

    Args:
      hlo_flops / hlo_bytes: per-chip numbers from ``cost_analysis()`` of
        the partitioned module, multiplied by ``chips`` by the caller if
        it recorded whole-step numbers. We treat them as WHOLE-STEP sums.
      collective_bytes: per-chip collective traffic from HLO parsing,
        times chips (whole-step).
      model_flops: 6 * N_active * tokens for a train step; 2 * N_active *
        tokens for serving.
    """
    peak = (peak_tflops or profile.theoretical.get("bf16", 197.0)) * 1e12
    hbm = profile.hbm_bw_gbps * 1e9
    link = profile.interconnect_gbps * 1e9  # per the task spec: per-link bw
    return RooflineTerms(
        cell=cell, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes, model_flops=model_flops,
        t_compute_s=hlo_flops / (chips * peak),
        t_memory_s=hlo_bytes / (chips * hbm),
        t_collective_s=collective_bytes / (chips * link))


# ----------------------------------------------------------------------
# table rendering for EXPERIMENTS.md
# ----------------------------------------------------------------------

def markdown_table(rows: List[RooflineTerms]) -> str:
    hdr = ("| cell | chips | compute s | memory s | collective s | dominant "
           "| 6ND/HLO | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r.cell} | {r.chips} | {r.t_compute_s:.3e} | "
            f"{r.t_memory_s:.3e} | {r.t_collective_s:.3e} | {r.dominant} | "
            f"{r.useful_flops_ratio:.2f} | {r.roofline_fraction:.2%} |")
    return "\n".join(lines)


def load_jsonl(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
