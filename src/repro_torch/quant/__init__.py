"""ggml-family block quantization (q8_0/q6_k/q4_k/q2_k), planes
bit-identical to the reference's ``repro.quant``."""

from repro_torch.quant.formats import (DENSE_BPW, FORMATS, QuantFormat,
                                       bits_per_weight, bytes_per_weight,
                                       get_format)
from repro_torch.quant.quantize import (PLANES, QTensor, dequantize,
                                        pack_nibbles, plane_layout,
                                        quantization_rmse, quantize,
                                        unpack_nibbles)

__all__ = [
    "DENSE_BPW", "FORMATS", "QuantFormat", "bits_per_weight",
    "bytes_per_weight", "get_format", "PLANES", "QTensor", "dequantize",
    "plane_layout",
    "pack_nibbles", "quantization_rmse", "quantize", "unpack_nibbles",
]
