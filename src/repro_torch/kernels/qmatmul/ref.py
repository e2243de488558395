"""Plain PyTorch versions of the quantized matmul kernel (K7)."""

from __future__ import annotations

import torch

from repro_torch.quant.quantize import QTensor, dequantize, true_div

__all__ = ["qmatmul_ref", "qmatmul_i8_ref"]


def qmatmul_ref(x: torch.Tensor, qt: QTensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize-then-matmul (the plain version of ``dequant_dot``; on
    the card TF32 must be off for the product to be float32)."""
    return (x.float() @ dequantize(qt)).to(out_dtype)


def qmatmul_i8_ref(x: torch.Tensor, qt: QTensor, qblock: int = 32,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Activation-quantized int8 dot (the plain version of ``dot_i8``,
    q8_0 only): x quantized per (row, ``qblock``-wide k-block), an exact
    integer dot per block, then ``part * x_scale * w_scale`` summed over
    blocks."""
    assert qt.fmt == "q8_0"
    m, k = x.shape
    nq = k // qblock
    xb = x.float().reshape(m, nq, qblock)
    x_scale = true_div(xb.abs().amax(dim=2), 127.0)
    x_scale = torch.where(x_scale == 0, torch.ones_like(x_scale), x_scale)
    xq = torch.round(xb / x_scale[:, :, None]).clamp(-127, 127)
    wq = qt.values.float().reshape(nq, qblock, -1)
    part = torch.einsum("mqk,qkn->qmn", xq, wq)
    part = part * x_scale.T[:, :, None] * qt.super_scales[:, None, :]
    return part.sum(dim=0).to(out_dtype)
