"""Decode attention: paged (K1; K4 over int8 pools) and dense
length-aware (K3; K5 int8) / masked (K6a; K6b int8) CUDA kernel
wrappers, one split-KV template, + plain versions."""

from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_paged, decode_attention_paged_q8,
    decode_attention_q8, kv_blocks_fetched, kv_pages_fetched, split_plan)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_q8_ref, decode_attention_paged_q8_split_ref,
    decode_attention_paged_ref, decode_attention_paged_split_ref,
    decode_attention_q8_ref, decode_attention_ref,
    decode_attention_split_ref, dequant_kv_q8, gather_pages, merge_partials,
    quantize_kv_q8, split_partials)

__all__ = ["decode_attention", "decode_attention_paged",
           "decode_attention_paged_q8", "decode_attention_q8",
           "decode_attention_paged_q8_ref",
           "decode_attention_paged_q8_split_ref", "decode_attention_paged_ref",
           "decode_attention_paged_split_ref",
           "decode_attention_q8_ref", "decode_attention_ref",
           "decode_attention_split_ref", "dequant_kv_q8", "gather_pages",
           "kv_blocks_fetched", "kv_pages_fetched", "merge_partials",
           "quantize_kv_q8", "split_partials", "split_plan"]
