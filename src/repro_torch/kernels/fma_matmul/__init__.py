"""Path-selectable matmul (K9): CUDA kernel wrappers, policy dispatch
and plain version."""

from repro_torch.kernels.fma_matmul.ops import (VARIANTS, matmul,
                                                matmul_variant,
                                                policy_variant)
from repro_torch.kernels.fma_matmul.ref import matmul_ref

__all__ = ["VARIANTS", "matmul", "matmul_variant", "policy_variant",
           "matmul_ref"]
