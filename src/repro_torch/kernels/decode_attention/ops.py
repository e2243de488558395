"""Wrapper for the paged decode attention kernel (K1).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches ``csrc/decode_attention_paged.cu`` or raises -- there is no
fallback on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        load)
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_paged_ref

__all__ = ["decode_attention_paged", "COUNTER"]

COUNTER = LaunchCounter("decode_attention_paged")
#: dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
_WARPS = 8                         # csrc: NW
_MAX_GROUP = 64                    # csrc: MAX_GROUP
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _smem_bytes(group: int, d: int) -> int:
    """Mirror of ``smem_bytes`` in the CUDA source."""
    return 4 * (group * d + _WARPS * group * d + 2 * _WARPS * group)


def _check(q, k_pages, v_pages, block_tables, kv_lengths):
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("kv_lengths", kv_lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype}: kernel takes float32/bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("k_pages/v_pages must have q's dtype")
    if block_tables.dtype != torch.int32 or kv_lengths.dtype != torch.int32:
        raise TypeError("block_tables and kv_lengths must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("want q (B,H,D), pools (P,Hkv,ps,D), tables (B,T)")
    b, h, d = q.shape
    p, hkv, ps, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError("k/v pools must match and share q's head dim")
    if h % hkv or h // hkv > _MAX_GROUP or d > 256 or d < 1:
        raise ValueError(f"need H % Hkv == 0, H/Hkv <= {_MAX_GROUP} and "
                         f"D <= 256 (H={h}, Hkv={hkv}, D={d})")
    if block_tables.shape[0] != b or kv_lengths.shape != (b,):
        raise ValueError("block_tables (B,T) and kv_lengths (B,) must "
                         "match q's batch")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("kv_lengths", kv_lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if _smem_bytes(h // hkv, d) > MAX_SMEM_BYTES:
        raise ValueError(f"query group {h // hkv} x D {d} exceeds the "
                         "kernel's shared memory")


def decode_attention_paged(q, k_pages, v_pages, block_tables, kv_lengths,
                           *, scale=None):
    """Block-table decode attention over a global page pool.

    q: (B, H, D); k_pages/v_pages: (P, Hkv, ps, D); block_tables: (B, T)
    int32 physical page ids in logical order; kv_lengths: (B,) int32.
    Returns (B, H, D) in q's dtype.  Positions at or past a lane's
    length (clamped to T*ps) are never read; a lane of length 0 gives 0.
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return decode_attention_paged_ref(q, k_pages, v_pages, block_tables,
                                          kv_lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_pages, v_pages, block_tables, kv_lengths)
    b, h, d = q.shape
    p, hkv, ps, _ = k_pages.shape
    t = block_tables.shape[1]
    out = torch.empty_like(q)
    lib = load("decode_attention_paged")
    fn = lib.decode_attention_paged_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), kv_lengths.data_ptr(),
                out.data_ptr(), b, h, hkv, p, ps, d, t, scale,
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise KernelLaunchError(f"decode_attention_paged: CUDA error {rc}")
    COUNTER.n += 1
    return out
