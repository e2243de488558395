"""Compute-path policy: route work onto the fastest unthrottled path (C2).

The paper's workaround -- compile llama.cpp / mixbench with
``-fmad=false`` so FP32 work flows through the (unthrottled) separate
multiply/add pipes -- generalizes to a *policy* object: given a
:class:`~repro_torch.core.device_profile.DeviceProfile` and an operation
descriptor, pick the kernel variant with the highest modeled throughput.

The port's kernels register their variants here:

========== ===================================  ========================
variant     CUDA kernel in this port             reference (TPU) meaning
========== ===================================  ========================
``fma``     fused multiply-add (``__fmaf_rn``)   MXU matmul (``jnp.dot``)
``mxu``     tensor-core tile product (K9)        MXU tile product
``mul_add`` ``__fmul_rn`` then ``__fadd_rn``     VPU multiply + add
``dot_i8``  ``__dp4a`` int8 dot, f32 epilogue    int8 MXU, f32 rescale
========== ===================================  ========================

A copy of the reference's ``repro.core.compute_path``: the same
decisions for the same profile and descriptor.  The policy is consulted
in Python before a launch, as the reference consults it at trace time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.device_profile import DeviceProfile, Path

# Map kernel-variant names onto capability paths.
VARIANT_TO_PATH = {
    "fma": Path.FMA,
    "mxu": Path.TENSOR,
    "mul_add": Path.MUL_ADD,
    "dot_i8": Path.DOT_I8,
}


@dataclasses.dataclass(frozen=True)
class OpDescriptor:
    """What a kernel is about to do, for throughput modeling.

    Attributes:
      flops: floating/integer op count of the op.
      bytes_moved: HBM traffic in bytes.
      precision: compute precision ("f32", "bf16", "f16", "i8", ...).
      supports: which variants the kernel implements.
    """

    flops: float
    bytes_moved: float
    precision: str
    supports: Sequence[str] = ("fma", "mul_add")


@dataclasses.dataclass(frozen=True)
class PathDecision:
    variant: str
    path: Path
    modeled_seconds: float
    compute_seconds: float
    memory_seconds: float
    bound: str  # "compute" | "memory"


class PathPolicy:
    """Selects the best kernel variant for a device profile."""

    def __init__(self, profile: DeviceProfile,
                 force_variant: Optional[str] = None):
        self.profile = profile
        self.force_variant = force_variant

    # ------------------------------------------------------------------
    def _variant_precision(self, variant: str, precision: str) -> str:
        # int8-dot variants compute in i8 regardless of the nominal
        # activation precision (scales are applied in f32 epilogue).
        return "i8" if variant == "dot_i8" else precision

    def modeled_time(self, op: OpDescriptor, variant: str) -> Optional[PathDecision]:
        path = VARIANT_TO_PATH[variant]
        prec = self._variant_precision(variant, op.precision)
        tf = self.profile.throughput(prec, path)
        if tf <= 0.0:
            # TENSOR and FMA are interchangeable namings across SKUs.
            if path == Path.TENSOR:
                tf = self.profile.throughput(prec, Path.FMA)
            elif path == Path.FMA:
                tf = self.profile.throughput(prec, Path.TENSOR)
        if tf <= 0.0:
            return None
        t_compute = op.flops / (tf * 1e12)
        t_memory = op.bytes_moved / (self.profile.hbm_bw_gbps * 1e9)
        t = max(t_compute, t_memory)
        return PathDecision(
            variant=variant, path=path, modeled_seconds=t,
            compute_seconds=t_compute, memory_seconds=t_memory,
            bound="compute" if t_compute >= t_memory else "memory")

    def decide(self, op: OpDescriptor) -> PathDecision:
        """Pick the fastest supported variant (the paper's C2 reroute)."""
        if self.force_variant is not None:
            d = self.modeled_time(op, self.force_variant)
            if d is None:
                raise ValueError(
                    f"forced variant {self.force_variant!r} has no path on "
                    f"{self.profile.name}")
            return d
        best: Optional[PathDecision] = None
        for variant in op.supports:
            d = self.modeled_time(op, variant)
            if d is not None and (best is None
                                  or d.modeled_seconds < best.modeled_seconds):
                best = d
        if best is None:
            raise ValueError(
                f"no supported variant of {op} runs on {self.profile.name}")
        return best


def matmul_descriptor(m: int, n: int, k: int, precision: str,
                      bytes_per_weight: float = 2.0,
                      supports: Sequence[str] = ("fma", "mul_add"),
                      ) -> OpDescriptor:
    """Descriptor for an (m,k) x (k,n) matmul streaming W once."""
    act_bytes = {"f32": 4, "f16": 2, "bf16": 2, "i8": 1}.get(precision, 2)
    return OpDescriptor(
        flops=2.0 * m * n * k,
        bytes_moved=k * n * bytes_per_weight + (m * k + m * n) * act_bytes,
        precision=precision,
        supports=supports)
