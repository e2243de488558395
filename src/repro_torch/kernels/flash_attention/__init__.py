"""Flash attention prefill (K2): CUDA kernel wrapper + plain version,
and the wrapper under autograd with its backward."""

from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn, attention_backward, flash_attention, flash_attention_fn)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["FlashAttentionFn", "attention_backward", "attention_ref",
           "flash_attention", "flash_attention_fn"]
