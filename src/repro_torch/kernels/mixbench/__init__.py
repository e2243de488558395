"""mixbench intensity sweep (K8): CUDA kernel wrapper, plain version
and the modeled sweep."""

from repro_torch.kernels.mixbench.ops import (VARIANTS, arithmetic_intensity,
                                              mixbench, sweep_points)
from repro_torch.kernels.mixbench.ref import mixbench_ref

__all__ = ["VARIANTS", "arithmetic_intensity", "mixbench", "sweep_points",
           "mixbench_ref"]
