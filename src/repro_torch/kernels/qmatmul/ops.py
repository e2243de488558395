"""Wrappers for the quantized matmul (K7) and its variant choice (C4).

On a profile with an unthrottled int8 path and a throttled f32 path (the
CMP 170HX), ``select_variant`` picks ``dot_i8`` for q8_0 weights; on a
TPU it also picks ``dot_i8``; formats without an int8 plane take
``dequant_dot``.  ``qmatmul_variant`` runs one variant: a CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/qmatmul.cu`` or raises -- there is no fallback on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.device_profile import DeviceProfile, Path
from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        load)
from repro_torch.kernels.qmatmul.ref import qmatmul_i8_ref, qmatmul_ref
from repro_torch.quant.quantize import PLANES, QTensor, plane_layout

__all__ = ["qmatmul", "qmatmul_variant", "select_variant", "VARIANTS",
           "COUNTER_DEQUANT_DOT", "COUNTER_DOT_I8"]

VARIANTS = ("dequant_dot", "dot_i8")
COUNTER_DEQUANT_DOT = LaunchCounter("qmatmul_dequant_dot")
COUNTER_DOT_I8 = LaunchCounter("qmatmul_dot_i8")
_FMT_CODE = {"q8_0": 0, "q6_k": 1, "q4_k": 2, "q2_k": 3}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_planes(x: torch.Tensor, qt: QTensor) -> None:
    """Every plane the format has, with its dtype and shape, contiguous,
    on x's device; none it lacks."""
    want = plane_layout(qt.fmt, qt.shape)
    for name in PLANES:
        t = getattr(qt, name)
        if name not in want:
            if t is not None:
                raise ValueError(f"{qt.fmt} has no {name} plane")
            continue
        shape, dtype = want[name]
        if t is None or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{qt.fmt} {name}: want {dtype}{shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def qmatmul_variant(x: torch.Tensor, qt: QTensor, *,
                    variant: str = "dequant_dot", bm: int = 128,
                    bk: int = 512, bn: int = 128) -> torch.Tensor:
    """(M, K) activations x block-quantized (K, N) weights -> (M, N)
    float32.

    The blocks are the reference's tiles and a contract check only:
    ``bk`` is clamped to a multiple of the format's block as the
    reference clamps it, and each dimension must be a multiple of its
    block.  The CUDA kernel picks its own tiles; x is float32 or
    bfloat16."""
    m, k = x.shape
    k2, n = qt.shape
    assert k == k2, (tuple(x.shape), qt.shape)
    fmt = qt.format
    bm, bn = min(bm, m), min(bn, n)
    bk = min(bk, k)
    bk = max(fmt.block, (bk // fmt.block) * fmt.block)
    assert m % bm == 0 and n % bn == 0 and k % bk == 0, (
        f"({m},{k},{n}) vs blocks ({bm},{bk},{bn})")
    if variant == "dot_i8":
        if qt.fmt != "q8_0":
            raise ValueError("dot_i8 variant requires q8_0 weights")
    elif variant != "dequant_dot":
        raise ValueError(f"unknown variant {variant!r}")
    if x.device.type == "cpu":
        if variant == "dot_i8":
            return qmatmul_i8_ref(x, qt, qblock=fmt.block)
        return qmatmul_ref(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype}: kernel takes float32/bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_planes(x, qt)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = load("qmatmul").qmatmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), qt.values.data_ptr(), _ptr(qt.sub_scales),
                _ptr(qt.sub_mins), qt.super_scales.data_ptr(),
                _ptr(qt.super_mins), out.data_ptr(), m, k, n,
                _FMT_CODE[qt.fmt], VARIANTS.index(variant),
                _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise KernelLaunchError(f"qmatmul ({variant}, {qt.fmt}): CUDA "
                                f"error {rc}")
    (COUNTER_DOT_I8 if variant == "dot_i8" else COUNTER_DEQUANT_DOT).n += 1
    return out


def select_variant(qt_fmt: str, profile: Optional[DeviceProfile]) -> str:
    if qt_fmt != "q8_0" or profile is None:
        return "dequant_dot"
    i8 = profile.throughput("i8", Path.DOT_I8)
    f16 = max(profile.throughput("f16", Path.FMA),
              profile.throughput("bf16", Path.TENSOR),
              profile.throughput("f16", Path.MUL_ADD))
    return "dot_i8" if i8 > f16 * 0.5 else "dequant_dot"


def qmatmul(x: torch.Tensor, qt: QTensor,
            profile: Optional[DeviceProfile] = None) -> torch.Tensor:
    """The variant ``select_variant`` picks for the weights' format on
    ``profile`` (``dequant_dot`` with no profile)."""
    return qmatmul_variant(x, qt, variant=select_variant(qt.fmt, profile))
