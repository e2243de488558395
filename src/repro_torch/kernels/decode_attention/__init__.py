"""Paged decode attention (K1): CUDA kernel wrapper + plain versions."""

from repro_torch.kernels.decode_attention.ops import decode_attention_paged
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_ref, decode_attention_ref, gather_pages)

__all__ = ["decode_attention_paged", "decode_attention_paged_ref",
           "decode_attention_ref", "gather_pages"]
