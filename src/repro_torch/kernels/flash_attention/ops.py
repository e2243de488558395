"""Wrapper for the flash attention prefill kernels (K2).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches one of the two kernels of ``csrc/flash_attention.cu`` or
raises -- there is no fallback on the card.  :func:`kernel_for` picks
the kernel from the dtype and head dim alone: bf16 at
``MMA_HEAD_DIMS`` (64, 96 and 128) runs on the tensor cores
(``flash_attention_mma``), everything else (float32, and bf16 at D 32
and 256) on the CUDA cores in f32 (``flash_attention_cc``); each has its
own launch counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        bind)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "kernel_for", "COUNTER_MMA", "COUNTER_CC",
           "HEAD_DIMS", "MMA_HEAD_DIMS"]

COUNTER_MMA = LaunchCounter("flash_attention_mma")
COUNTER_CC = LaunchCounter("flash_attention_cc")
#: head dims a kernel is instantiated for (csrc: flash_attention_fwd)
HEAD_DIMS = (32, 64, 96, 128, 256)
#: head dims of the bf16 tensor-core kernel (at 96, phi-3-vision's, a
#: row comes as three 64-byte TMA boxes with the 64-byte swizzle, not
#: 128-byte ones); at 256 its f32 accumulators would not fit in
#: registers, and 32 (the float32 SMOKE configs') no bf16 model serves,
#: so bf16 D 32 and 256 stay on the CUDA cores
MMA_HEAD_DIMS = (64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CODE = {"cc": 0, "mma": 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """``"mma"`` (tensor cores) for bf16 at ``MMA_HEAD_DIMS``, else
    ``"cc"`` (CUDA cores, f32): float32 keeps full f32 products, which
    the float32 tolerance and the token-exact float32 serve need."""
    if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS:
        return "mma"
    return "cc"


def _check(q, k, v, window):
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: kernel "
                        "takes one of float32/bfloat16 for all three")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("want q (B,H,Sq,D) and k/v (B,Hkv,Sk,D)")
    b, h, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d or h % hkv:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if kernel_for(q.dtype, d) == "mma" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the tensor-core kernel reads it by TMA)")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, H, Sq, D).

    GQA maps query head h to KV head h // (H/Hkv); ``window`` keeps keys
    with ``q_pos - k_pos < window``; rows with no live key give 0.
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, window)
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    kernel = kernel_for(q.dtype, d)
    out = torch.empty_like(q)
    fn = bind("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, hkv, sq, sk, d, int(bool(causal)),
                -1 if window is None else int(window), scale,
                _DTYPE_CODE[q.dtype], _KERNEL_CODE[kernel], stream)
    if rc != 0:
        raise KernelLaunchError(f"flash_attention ({kernel}): CUDA error "
                                f"{rc}")
    (COUNTER_MMA if kernel == "mma" else COUNTER_CC).n += 1
    return out
