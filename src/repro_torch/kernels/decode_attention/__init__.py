"""Decode attention: paged (K1) and dense length-aware (K3) / masked
(K6a) CUDA kernel wrappers + plain versions."""

from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_paged)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_ref, decode_attention_ref, gather_pages)

__all__ = ["decode_attention", "decode_attention_paged",
           "decode_attention_paged_ref", "decode_attention_ref",
           "gather_pages"]
