"""Path-selectable matmul (K9): CUDA kernel wrappers, policy dispatch
and plain version."""

from repro_torch.kernels.fma_matmul.ops import (VARIANTS, matmul,
                                                matmul_variant,
                                                policy_variant, stream_plan,
                                                stream_rows)
from repro_torch.kernels.fma_matmul.ref import matmul_ref

__all__ = ["VARIANTS", "matmul", "matmul_variant", "policy_variant",
           "stream_plan", "stream_rows", "matmul_ref"]
