"""Quantize / dequantize in plain PyTorch (the port of ``repro.quant``).

These are the plain versions behind the ``qmatmul`` kernel (K7) and
the weight store a quantized serve would use.  Layouts are the
structure-of-arrays planes described in :mod:`repro_torch.quant.formats`.

A weight matrix ``w[k, n]`` is quantized along ``k`` (axis 0, the
matmul's reduction axis), so a kernel can dequantize a (bk, bn) tile
with per-k-block scales; ``k`` must be a multiple of the format's block.

Every plane is bit-identical to the reference's for the same input:
the same f32 operations in the same order, each division kept a
division (:func:`true_div`), and ``torch.round`` rounding half to even
as ``jnp.round`` does.  The functions run on whatever device ``w`` lies
on, with the same planes on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.quant.formats import QuantFormat, get_format

__all__ = ["QTensor", "PLANES", "plane_layout", "pack_nibbles",
           "unpack_nibbles", "quantize", "dequantize", "quantization_rmse",
           "true_div", "QUANTIZERS"]


def true_div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` correctly rounded on every device.  PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which can
    differ from the quotient in the last bit; a divisor tensor on t's
    device keeps the division."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)


@dataclasses.dataclass
class QTensor:
    """A block-quantized 2-D tensor in plane layout.

    values:      int8 (q8_0/q6_k) or packed uint8 (q4_k: 2/byte,
                 q2_k: 4/byte), shape (k_packed, n).
    sub_scales:  int8, shape (k/sub, n)   -- None for q8_0.
    sub_mins:    int8, shape (k/sub, n)   -- only asymmetric formats.
    super_scales:f32, shape (k/block, n)  -- per-block scale of sub_scales.
    super_mins:  f32, shape (k/block, n)  -- per-block scale of sub_mins.
    """

    fmt: str
    shape: tuple
    values: torch.Tensor
    super_scales: torch.Tensor
    sub_scales: Optional[torch.Tensor] = None
    sub_mins: Optional[torch.Tensor] = None
    super_mins: Optional[torch.Tensor] = None

    @property
    def format(self) -> QuantFormat:
        return get_format(self.fmt)

    def planes(self):
        """(values, super_scales, sub_scales, sub_mins, super_mins)."""
        return (self.values, self.super_scales, self.sub_scales,
                self.sub_mins, self.super_mins)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.planes()
                   if t is not None)


PLANES = ("values", "super_scales", "sub_scales", "sub_mins", "super_mins")


def plane_layout(fmt: str, shape) -> dict:
    """{plane name: (shape, dtype)} of every plane a ``fmt`` QTensor of
    ``shape`` (k, n) holds; the planes it lacks are absent."""
    f = get_format(fmt)
    k, n = shape
    out = {"values": ((k // f.values_per_byte, n),
                      torch.uint8 if f.values_per_byte > 1 else torch.int8),
           "super_scales": ((k // f.block, n), torch.float32)}
    if f.sub_block is not None:
        out["sub_scales"] = ((k // f.sub_block, n), torch.int8)
    if f.asymmetric:
        out["sub_mins"] = ((k // f.sub_block, n), torch.int8)
        out["super_mins"] = ((k // f.block, n), torch.float32)
    return out


# ----------------------------------------------------------------------
# packing helpers
# ----------------------------------------------------------------------

def pack_nibbles(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned ints (< 2**bits) along axis 0 into uint8, low bits
    first."""
    per = 8 // bits
    k, n = v.shape
    assert k % per == 0
    v = v.to(torch.uint8).reshape(k // per, per, n)
    out = torch.zeros((k // per, n), dtype=torch.uint8, device=v.device)
    for i in range(per):
        out = out | (v[:, i, :] << (bits * i))
    return out


def unpack_nibbles(p: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles` -> uint8 in [0, 2**bits)."""
    per = 8 // bits
    mask = (1 << bits) - 1
    parts = [(p >> (bits * i)) & mask for i in range(per)]
    kp, n = p.shape
    return torch.stack(parts, dim=1).reshape(kp * per, n)


# ----------------------------------------------------------------------
# quantizers
# ----------------------------------------------------------------------

def _one_where_zero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t == 0, torch.ones_like(t), t)


def _blockwise_absmax_scale(w, block, qmax):
    """Per-(block,n) scale mapping w -> integers in [-qmax, qmax]."""
    k, n = w.shape
    wb = w.reshape(k // block, block, n)
    amax = wb.abs().amax(dim=1)
    return wb, _one_where_zero(true_div(amax, qmax))


def quantize_q8_0(w: torch.Tensor) -> QTensor:
    """Symmetric int8, block 32, one f32 scale per block (ggml Q8_0)."""
    fmt = get_format("q8_0")
    wb, scale = _blockwise_absmax_scale(w.float(), fmt.block, 127.0)
    q = torch.round(wb / scale[:, None, :]).clamp(-127, 127).to(torch.int8)
    k, n = w.shape
    return QTensor(fmt="q8_0", shape=(k, n), values=q.reshape(k, n),
                   super_scales=scale)


def _two_level_symmetric(w, fmt, qmax):
    """Shared machinery for symmetric k-quants (q6_k)."""
    k, n = w.shape
    sub = fmt.sub_block
    # inner: per-sub-block f32 scale
    wsb = w.float().reshape(k // sub, sub, n)
    d_sub = true_div(wsb.abs().amax(dim=1), qmax)        # (k/sub, n)
    # outer: quantize d_sub itself to int8 against a per-block super scale
    per = fmt.block // sub
    d_grp = d_sub.reshape(k // fmt.block, per, n)
    d_super = _one_where_zero(true_div(d_grp.amax(dim=1), 127.0))
    q_sub = torch.round(d_grp / d_super[:, None, :]).clamp(0, 127).to(
        torch.int8)                                      # (k/block, per, n)
    # effective dequantized sub scale actually used for value coding:
    eff = _one_where_zero(q_sub.float() * d_super[:, None, :]).reshape(
        k // sub, n)
    q = torch.round(wsb / eff[:, None, :]).clamp(-qmax, qmax)
    return q.reshape(k, n), q_sub.reshape(k // sub, n), d_super


def quantize_q6_k(w: torch.Tensor) -> QTensor:
    """6-bit symmetric, sub 16 / super 256 (ggml Q6_K algebra)."""
    q, q_sub, d_super = _two_level_symmetric(w, get_format("q6_k"),
                                             qmax=31.0)
    return QTensor(fmt="q6_k", shape=tuple(w.shape),
                   values=q.to(torch.int8), sub_scales=q_sub,
                   super_scales=d_super)


def _two_level_asymmetric(w, fmt, qmax, scale_qmax):
    """Asymmetric k-quants (q4_k, q2_k): value = d*q - m per sub-block."""
    k, n = w.shape
    sub = fmt.sub_block
    wsb = w.float().reshape(k // sub, sub, n)
    m_sub = torch.clamp_min(-wsb.amin(dim=1), 0.0)       # min offset >= 0
    d_sub = _one_where_zero(true_div(wsb.amax(dim=1) + m_sub, qmax))
    per = fmt.block // sub
    d_grp = d_sub.reshape(k // fmt.block, per, n)
    m_grp = m_sub.reshape(k // fmt.block, per, n)
    d_super = torch.clamp_min(true_div(d_grp.amax(dim=1), scale_qmax),
                              1e-12)
    m_max = m_grp.amax(dim=1)
    m_super = torch.where(m_max == 0, torch.ones_like(m_max),
                          true_div(m_max, scale_qmax))
    q_dsub = torch.round(d_grp / d_super[:, None, :]).clamp(
        0, scale_qmax).to(torch.int8)
    q_msub = torch.round(m_grp / m_super[:, None, :]).clamp(
        0, scale_qmax).to(torch.int8)
    eff_d = _one_where_zero(q_dsub.float() * d_super[:, None, :]).reshape(
        k // sub, n)
    eff_m = (q_msub.float() * m_super[:, None, :]).reshape(k // sub, n)
    q = torch.round((wsb + eff_m[:, None, :]) / eff_d[:, None, :]).clamp(
        0, qmax)
    return (q.reshape(k, n), q_dsub.reshape(k // sub, n),
            q_msub.reshape(k // sub, n), d_super, m_super)


def _quantize_asymmetric(w, name, qmax, scale_qmax) -> QTensor:
    fmt = get_format(name)
    q, q_d, q_m, d_super, m_super = _two_level_asymmetric(
        w, fmt, qmax=qmax, scale_qmax=scale_qmax)
    return QTensor(fmt=name, shape=tuple(w.shape),
                   values=pack_nibbles(q.to(torch.uint8), fmt.bits),
                   sub_scales=q_d, sub_mins=q_m, super_scales=d_super,
                   super_mins=m_super)


def quantize_q4_k(w: torch.Tensor) -> QTensor:
    return _quantize_asymmetric(w, "q4_k", 15.0, 63.0)


def quantize_q2_k(w: torch.Tensor) -> QTensor:
    return _quantize_asymmetric(w, "q2_k", 3.0, 15.0)


QUANTIZERS = {
    "q8_0": quantize_q8_0,
    "q6_k": quantize_q6_k,
    "q4_k": quantize_q4_k,
    "q2_k": quantize_q2_k,
}


def quantize(w: torch.Tensor, fmt: str) -> QTensor:
    if w.dim() != 2:
        raise ValueError(f"quantize expects 2-D [k, n] weights, got "
                         f"{tuple(w.shape)}")
    blk = get_format(fmt).block
    if w.shape[0] % blk:
        raise ValueError(f"k={w.shape[0]} not a multiple of block {blk}")
    return QUANTIZERS[fmt](w)


# ----------------------------------------------------------------------
# dequantize (the plain version of K7's dequant_dot tile)
# ----------------------------------------------------------------------

def dequantize(qt: QTensor) -> torch.Tensor:
    k, n = qt.shape
    fmt = qt.format
    if qt.fmt == "q8_0":
        scale = qt.super_scales.repeat_interleave(fmt.block, dim=0)
        return qt.values.float() * scale
    sub = fmt.sub_block
    per = fmt.block // sub
    d_super = qt.super_scales.repeat_interleave(per, dim=0)
    eff_d = _one_where_zero(qt.sub_scales.float() * d_super)
    eff_d = eff_d.repeat_interleave(sub, dim=0)
    if qt.fmt == "q6_k":
        return qt.values.float() * eff_d
    # asymmetric 4/2-bit: a multiply, then a subtract, each rounded
    q = unpack_nibbles(qt.values, fmt.bits).float()[:k]
    m_super = qt.super_mins.repeat_interleave(per, dim=0)
    eff_m = (qt.sub_mins.float() * m_super).repeat_interleave(sub, dim=0)
    return q * eff_d - eff_m


def quantization_rmse(w: torch.Tensor, fmt: str) -> float:
    """Round-trip RMS error relative to weight RMS (property-test metric)."""
    back = dequantize(quantize(w, fmt))
    w32 = w.float()
    num = torch.sqrt(torch.mean((w32 - back) ** 2))
    den = torch.sqrt(torch.mean(w32 ** 2)) + 1e-12
    return float(num / den)
