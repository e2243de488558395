"""ggml-family block-quantization formats in plane layout (C4).

A copy of the reference's ``repro.quant.formats``: the same formats,
block geometry and bits per weight, so a ``QTensor`` of the port holds
the same planes as the reference's.  The notes below are the
reference's; the port's CUDA kernel (``csrc/qmatmul.cu``) reads the
same structure-of-arrays planes.

The paper evaluates llama.cpp's F32/F16/Q8_0/Q6_K/Q4_K_M/Q2_K model
formats on the CMP 170HX.  We reproduce the *algebra* of those formats
faithfully -- block sizes, two-level scale hierarchies, symmetric vs
asymmetric (min-offset) coding -- while adapting the *memory layout* to
the TPU memory hierarchy:

* ggml interleaves scales and packed values per 32/256-element block so a
  CUDA warp can dequantize from one 128-byte read. A TPU VPU instead wants
  **structure-of-arrays planes**: one contiguous int8/packed-uint8 value
  plane plus small scale planes, so a Pallas kernel can load clean
  (8,128)-tiled blocks and unpack with vectorized shifts/masks.
* ggml's f16 super-scales become f32 here (TPU has no f16 ALU; bf16 would
  cost precision on the scale).  This costs 2 bytes / 256 values =
  0.0625 bpw, which we account for separately (``bpw_tpu`` vs ``bpw``).

Bits-per-weight (``bpw``) follows ggml exactly and drives the *bandwidth*
performance model -- decode throughput on a bandwidth-rich device is
``hbm_bw / bytes(active weights)``, which is precisely the paper's Graph
4-2 theoretical line.

Block geometry (all lane-aligned for TPU: 32 | 128, 256 = 2x128):

=========  ======  =========  ==========================================
format     block   sub-block  coding
=========  ======  =========  ==========================================
``q8_0``   32      --         int8 value x f16 scale (symmetric)
``q6_k``   256     16         6-bit value x (int8 sub-scale x f16 super)
``q4_k``   256     32         4-bit value x (6-bit sub-scale/min x 2xf16)
``q2_k``   256     16         2-bit value x (4-bit sub-scale/min x 2xf16)
=========  ======  =========  ==========================================
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class QuantFormat:
    """Static description of one block-quant format.

    Attributes:
      name: ggml-compatible name.
      bits: value bits.
      block: elements sharing the outer (super) scale.
      sub_block: elements sharing the inner scale (None = no hierarchy).
      asymmetric: True if sub-blocks carry a min offset (Q4_K/Q2_K).
      bpw: effective bits/weight of the *ggml* packed layout (drives the
        bandwidth model; matches llama.cpp's tensor sizes).
      bpw_tpu: bits/weight of our structure-of-arrays TPU layout.
      values_per_byte: packing density of the value plane on TPU.
    """

    name: str
    bits: int
    block: int
    sub_block: Optional[int]
    asymmetric: bool
    bpw: float
    bpw_tpu: float
    values_per_byte: int

    @property
    def n_sub(self) -> int:
        return 1 if self.sub_block is None else self.block // self.sub_block


# ggml bpw references: q8_0 = 34B/32 = 8.5; q6_k = 210B/256 = 6.5625;
# q4_k = 144B/256 = 4.5; q2_k = 84B/256 = 2.625 (llama.cpp Q2_K block:
# 16 sub scales + 16 mins (4b each) + 64B values + 2xf16 = 84 bytes).
FORMATS: Dict[str, QuantFormat] = {
    "q8_0": QuantFormat(
        name="q8_0", bits=8, block=32, sub_block=None, asymmetric=False,
        bpw=8.5, bpw_tpu=8.0 + 32.0 / 32.0, values_per_byte=1),
    "q6_k": QuantFormat(
        name="q6_k", bits=6, block=256, sub_block=16, asymmetric=False,
        bpw=6.5625,
        # TPU plane: 6-bit values stored as int8 (+2 pad bits), int8
        # sub-scales, f32 super-scale.
        bpw_tpu=8.0 + 16 * 8.0 / 256.0 + 32.0 / 256.0, values_per_byte=1),
    "q4_k": QuantFormat(
        name="q4_k", bits=4, block=256, sub_block=32, asymmetric=True,
        bpw=4.5,
        bpw_tpu=4.0 + 8 * (8.0 + 8.0) / 256.0 + 2 * 32.0 / 256.0,
        values_per_byte=2),
    "q2_k": QuantFormat(
        name="q2_k", bits=2, block=256, sub_block=16, asymmetric=True,
        bpw=2.625,
        bpw_tpu=2.0 + 16 * (8.0 + 8.0) / 256.0 + 2 * 32.0 / 256.0,
        values_per_byte=4),
}

# The paper additionally benchmarks unquantized f32/f16 ggufs; model them
# as degenerate "formats" so the perf model can sweep one axis.
DENSE_BPW = {"f32": 32.0, "f16": 16.0, "bf16": 16.0}


def bits_per_weight(fmt: str) -> float:
    if fmt in FORMATS:
        return FORMATS[fmt].bpw
    if fmt in DENSE_BPW:
        return DENSE_BPW[fmt]
    raise KeyError(f"unknown format {fmt!r}")


def bytes_per_weight(fmt: str) -> float:
    return bits_per_weight(fmt) / 8.0


def get_format(name: str) -> QuantFormat:
    try:
        return FORMATS[name]
    except KeyError as e:
        raise KeyError(f"unknown quant format {name!r}; "
                       f"known: {sorted(FORMATS)}") from e
