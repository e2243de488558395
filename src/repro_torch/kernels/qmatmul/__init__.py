"""Block-quantized matmul (K7): CUDA kernel wrappers, variant choice and
plain versions."""

from repro_torch.kernels.qmatmul.ops import (TILES, VARIANTS, qmatmul,
                                             qmatmul_plan, qmatmul_variant,
                                             select_variant)
from repro_torch.kernels.qmatmul.ref import qmatmul_i8_ref, qmatmul_ref

__all__ = ["TILES", "VARIANTS", "qmatmul", "qmatmul_plan", "qmatmul_variant",
           "select_variant",
           "qmatmul_i8_ref", "qmatmul_ref"]
