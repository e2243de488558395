"""Per-path device capability profiles (paper contribution C1).

The central lesson of the CMP 170HX study is that a device is not a single
FLOP/s number: every (precision x instruction-path) pair has its own
throughput ceiling, and a SKU-level throttle may hit one path (FMA) while
leaving others (separate mul/add, int8 dot, HBM) untouched.

A :class:`DeviceProfile` is the port's source of truth for those
ceilings; it drives the compute-path policy (``core.compute_path``),
which picks a kernel variant for a given device, and
``kernels.qmatmul.select_variant``.  The profiles and their numbers are
the JAX reference's own (``repro.core.device_profile``), copied so the
port imports nothing of it; the policy must choose the same variant on
both sides.

Numbers for the CMP 170HX come from the paper (Tables 2-1..2-4, Graphs
3-1..3-5, EX.1/EX.2); A100 numbers from the NVIDIA datasheet the paper
cites; TPU v5e numbers from the reference's hardware constants.  None of
them is a measurement of the H100 this port runs on.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Mapping, Optional, Tuple


class Path(enum.Enum):
    """An instruction/issue path on the device.

    ``FMA``     fused multiply-add pipeline (CUDA default codegen; the MXU
                systolic path on TPU).
    ``MUL_ADD`` decomposed multiply + add (``-fmad=false`` on CUDA; the VPU
                vector path on TPU).
    ``DOT_I8``  integer-8 dot-product path (dp4a on GPU; int8 MXU on TPU).
    ``TENSOR``  matrix-engine path with its own ratios (TensorCore / MXU).
    """

    FMA = "fma"
    MUL_ADD = "mul_add"
    DOT_I8 = "dot_i8"
    TENSOR = "tensor"


# (precision, path) -> TFLOP/s (or TOP/s for integer precisions).
PathTable = Mapping[Tuple[str, Path], float]


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Capability table of one accelerator SKU.

    Attributes:
      name: SKU name.
      peak: per-(precision, path) achievable throughput in T(FL)OP/s.
        *Achievable* means "what a well-written kernel on the right path
        reaches", i.e. the paper's measured values, not marketing peaks.
      theoretical: the datasheet/derived theoretical ceilings per
        precision, used to report "fraction of theoretical" like the paper.
      hbm_bw_gbps: achievable HBM bandwidth, GB/s.
      hbm_capacity_gib: HBM capacity per chip/board, GiB.
      interconnect_gbps: per-direction device interconnect bandwidth, GB/s
        (PCIe for the mining card, per-link ICI for TPU).
      interconnect_links: number of interconnect links (ICI torus links).
      tdp_watts: board TDP.
      asp_usd: estimated average selling price (paper Table 1-1), for the
        cost model. ``None`` if not applicable.
      notes: provenance of the numbers.
    """

    name: str
    peak: PathTable
    theoretical: Mapping[str, float]
    hbm_bw_gbps: float
    hbm_capacity_gib: float
    interconnect_gbps: float
    interconnect_links: int
    tdp_watts: float
    asp_usd: Optional[float] = None
    notes: str = ""
    # Which path a *standard compiled build* routes each precision through
    # (the paper's default vs -fmad=false distinction).  Hand-written
    # kernels may use any path in ``peak``; framework codegen uses these.
    build_paths: Mapping[str, "Path"] = dataclasses.field(default_factory=dict)
    # Effective throughput of vendor BLAS GEMMs (TF), which are pre-built
    # binaries NOT affected by the -fmad recompile (paper: f32/f16 ggufs
    # showed no noFMA gains because cuBLAS does the GEMM).
    blas_tflops: Mapping[str, float] = dataclasses.field(default_factory=dict)
    # Achievable fraction of hbm_bw_gbps in a GEMV-style streaming kernel
    # (decode).  The mining card's PCIe-x4 host link + kernel overheads
    # cost it more than the A100.
    gemv_efficiency: float = 0.80

    # ------------------------------------------------------------------
    def throughput(self, precision: str, path: Path) -> float:
        """Achievable T(FL)OP/s of ``precision`` via ``path`` (0 if absent)."""
        return float(self.peak.get((precision, path), 0.0))

    def best_path(self, precision: str) -> Tuple[Path, float]:
        """The fastest path for ``precision`` and its throughput."""
        best, best_tf = None, 0.0
        for (prec, path), tf in self.peak.items():
            if prec == precision and tf >= best_tf:
                best, best_tf = path, tf
        if best is None:
            raise KeyError(f"{self.name}: no path for precision {precision!r}")
        return best, best_tf

    def fraction_of_theoretical(self, precision: str, path: Path) -> float:
        theo = self.theoretical.get(precision)
        if not theo:
            return 0.0
        return self.throughput(precision, path) / theo

    def total_interconnect_gbps(self) -> float:
        return self.interconnect_gbps * self.interconnect_links


# ----------------------------------------------------------------------
# Profile registry
# ----------------------------------------------------------------------

def _cmp170hx_peaks(fma_disabled: bool) -> Dict[Tuple[str, Path], float]:
    """CMP 170HX measured capability (paper Graphs 3-1..3-4, EX.1).

    Default build: FP32 via FMA runs at ~1/32 of the 12.63 TFLOPS
    theoretical -> 0.39 TFLOPS.  ``-fmad=false`` reroutes onto the
    mul+add path -> ~6.2 TFLOPS (1/2 of theoretical: no fusion means two
    instructions per multiply-accumulate).  FP16 (non-TensorCore) is
    unthrottled either way (~48 TFLOPS, RTX-4080-class per the paper);
    frameworks that lower FP16 through the FMA path (PyTorch, GPU-Burn)
    see only ~6.3.  FP64 is ~1/64 of its 6.317 theoretical and *halves
    again* without FMA.  INT32/INT8 are essentially unthrottled.
    """
    if not fma_disabled:
        return {
            ("f32", Path.FMA): 0.39,
            ("f32", Path.MUL_ADD): 6.2,     # reachable per-kernel even in default builds
            ("f16", Path.FMA): 6.3,          # what PyTorch/GPU-Burn observe
            ("f16", Path.MUL_ADD): 48.7,     # OpenCL half2 path, ~RTX 4080 class
            ("f64", Path.FMA): 0.197,        # ~1/32 of 6.317
            ("i32", Path.FMA): 9.8,          # TIOPs, "not significantly restricted"
            ("i8", Path.DOT_I8): 25.1,       # dp4a (EX.1: 25.13 / 21.77)
        }
    return {
        ("f32", Path.MUL_ADD): 6.2,          # the paper's headline recovery
        ("f16", Path.FMA): 6.3,              # framework f16 path: unchanged
        ("f16", Path.MUL_ADD): 48.7,         # unchanged by FMA status
        ("f64", Path.MUL_ADD): 0.10,         # 1/128: halves again
        ("i32", Path.MUL_ADD): 9.8,
        ("i8", Path.DOT_I8): 21.6,           # EX.1 noFMA bar
    }


CMP_170HX = DeviceProfile(
    name="cmp-170hx",
    peak=_cmp170hx_peaks(fma_disabled=False),
    theoretical={"f32": 12.63, "f16": 50.53, "f64": 6.317, "i32": 12.63, "i8": 50.5},
    hbm_bw_gbps=1290.0,              # ~86% of 1493 GB/s theoretical, streaming
    hbm_capacity_gib=8.0,
    interconnect_gbps=1.0,           # PCIe 1.1 x4 ~= 1 GB/s/dir (EX.2)
    interconnect_links=1,
    tdp_watts=250.0,
    asp_usd=4500.0,
    notes="paper Tables 2-1..2-4, Graphs 3-1..3-5, EX.1/EX.2",
    gemv_efficiency=0.70,           # PCIe-x4 host link + GEMV overheads
    build_paths={"f32": Path.FMA, "f16": Path.FMA, "f64": Path.FMA,
                 "i32": Path.FMA, "i8": Path.DOT_I8},
    # cuBLAS pre-built binaries: SGEMM lands ~2.8 TF on the throttled die
    # (instruction mix partially escapes the FMA throttle), HGEMM ~6.3 TF
    # (no TensorCores usable).  Both are -fmad-insensitive.
    blas_tflops={"f32": 2.8, "f16": 6.3},
)

CMP_170HX_NOFMA = dataclasses.replace(
    CMP_170HX,
    name="cmp-170hx-nofma",
    peak=_cmp170hx_peaks(fma_disabled=True),
    notes="paper: -fmad=false build (niconiconi workaround)",
    gemv_efficiency=0.70,
    build_paths={"f32": Path.MUL_ADD, "f16": Path.FMA,
                 "f64": Path.MUL_ADD, "i32": Path.MUL_ADD,
                 "i8": Path.DOT_I8},
    blas_tflops={"f32": 2.8, "f16": 6.3},   # vendor BLAS unaffected
)

A100_40G = DeviceProfile(
    name="a100-40g",
    peak={
        ("f32", Path.FMA): 19.5,
        ("f32", Path.MUL_ADD): 9.75,
        ("f16", Path.FMA): 78.0,
        ("f16", Path.TENSOR): 312.0,
        ("f64", Path.FMA): 9.7,
        ("i32", Path.FMA): 19.5,
        ("i8", Path.DOT_I8): 624.0,
    },
    theoretical={"f32": 19.5, "f16": 312.0, "f64": 9.7, "i32": 19.5, "i8": 624.0},
    hbm_bw_gbps=1555.0,
    hbm_capacity_gib=40.0,
    interconnect_gbps=64.0,          # PCIe 4 x16
    interconnect_links=1,
    tdp_watts=250.0,
    asp_usd=10000.0,
    notes="NVIDIA A100 40GB PCIe datasheet (paper refs [21][22])",
    gemv_efficiency=0.82,
    build_paths={"f32": Path.FMA, "f16": Path.TENSOR, "f64": Path.FMA,
                 "i32": Path.FMA, "i8": Path.DOT_I8},
    blas_tflops={"f32": 16.5, "f16": 53.0},  # ~17% of TC peak: llama.cpp-class
)

# The reproduction target. bf16 is the native matrix precision; the VPU
# (mul_add path) runs ~8 ops/cycle/lane -> roughly peak/16 of the MXU for
# f32 elementwise chains.  int8 runs at 2x bf16 on v5e MXU (394 TOPS).
TPU_V5E = DeviceProfile(
    name="tpu-v5e",
    peak={
        ("bf16", Path.TENSOR): 197.0,
        ("bf16", Path.FMA): 197.0,
        ("f32", Path.TENSOR): 98.5,
        ("f32", Path.FMA): 98.5,
        ("f32", Path.MUL_ADD): 12.3,   # VPU vector path
        ("bf16", Path.MUL_ADD): 12.3,
        ("i8", Path.DOT_I8): 394.0,
    },
    theoretical={"bf16": 197.0, "f32": 98.5, "i8": 394.0},
    hbm_bw_gbps=819.0,
    hbm_capacity_gib=16.0,
    interconnect_gbps=50.0,          # per ICI link
    interconnect_links=4,            # 2D torus
    tdp_watts=170.0,
    asp_usd=None,
    notes="task hardware constants: 197 TFLOP/s bf16, 819 GB/s, 50 GB/s/link",
    build_paths={"bf16": Path.TENSOR, "f16": Path.TENSOR,
                 "f32": Path.TENSOR, "i8": Path.DOT_I8},
    blas_tflops={"f32": 78.0, "f16": 160.0, "bf16": 160.0},  # XLA GEMM ~0.8 MXU
)

PROFILES: Dict[str, DeviceProfile] = {
    p.name: p
    for p in (CMP_170HX, CMP_170HX_NOFMA, A100_40G, TPU_V5E)
}


def get_profile(name: str) -> DeviceProfile:
    try:
        return PROFILES[name]
    except KeyError as e:
        raise KeyError(
            f"unknown device profile {name!r}; known: {sorted(PROFILES)}") from e


def register_profile(profile: DeviceProfile) -> None:
    """Register a custom SKU (e.g. a hypothetical degraded TPU)."""
    PROFILES[profile.name] = profile
