"""The paper's capability model, copied from the reference for the port.

C1 capability characterization -> :mod:`repro_torch.core.device_profile`
C2 compute-path rerouting      -> :mod:`repro_torch.core.compute_path`
C3 analytic performance model  -> :mod:`repro_torch.core.perf_model`
C5 energy / fleet economics    -> :mod:`repro_torch.core.energy`
"""

from repro_torch.core.compute_path import (OpDescriptor, PathDecision,
                                           PathPolicy, VARIANT_TO_PATH,
                                           matmul_descriptor)
from repro_torch.core.device_profile import (A100_40G, CMP_170HX,
                                             CMP_170HX_NOFMA, PROFILES,
                                             TPU_V5E, DeviceProfile, Path,
                                             get_profile, register_profile)
from repro_torch.core.perf_model import (QWEN25_1P5B, InferencePerfModel,
                                         LLMSpec, PhaseEstimate,
                                         f32_epilogue_ops_per_weight, sweep)

__all__ = [
    "OpDescriptor", "PathDecision", "PathPolicy", "VARIANT_TO_PATH",
    "matmul_descriptor", "A100_40G", "CMP_170HX", "CMP_170HX_NOFMA",
    "PROFILES", "TPU_V5E", "DeviceProfile", "Path", "get_profile",
    "register_profile", "QWEN25_1P5B", "InferencePerfModel", "LLMSpec",
    "PhaseEstimate", "f32_epilogue_ops_per_weight", "sweep",
]
