"""The paper's capability model, copied from the reference for the port.

C1 capability characterization -> :mod:`repro_torch.core.device_profile`
C2 compute-path rerouting      -> :mod:`repro_torch.core.compute_path`
"""

from repro_torch.core.compute_path import (OpDescriptor, PathDecision,
                                           PathPolicy, VARIANT_TO_PATH,
                                           matmul_descriptor)
from repro_torch.core.device_profile import (A100_40G, CMP_170HX,
                                             CMP_170HX_NOFMA, PROFILES,
                                             TPU_V5E, DeviceProfile, Path,
                                             get_profile, register_profile)

__all__ = [
    "OpDescriptor", "PathDecision", "PathPolicy", "VARIANT_TO_PATH",
    "matmul_descriptor", "A100_40G", "CMP_170HX", "CMP_170HX_NOFMA",
    "PROFILES", "TPU_V5E", "DeviceProfile", "Path", "get_profile",
    "register_profile",
]
