"""Wrappers for the decode attention kernels: paged (K1) and dense
length-aware (K3) / masked (K6a).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches ``csrc/decode_attention_paged.cu`` or
``csrc/decode_attention_dense.cu`` or raises -- there is no fallback on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        load)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_ref, decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_paged", "COUNTER",
           "COUNTER_LENGTHAWARE", "COUNTER_MASKED"]

COUNTER = LaunchCounter("decode_attention_paged")
COUNTER_LENGTHAWARE = LaunchCounter("decode_attention_lengthaware")
COUNTER_MASKED = LaunchCounter("decode_attention_masked")
#: dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
_WARPS = 8                         # csrc: NW
_MAX_GROUP = 64                    # csrc: MAX_GROUP
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _smem_bytes(group: int, d: int) -> int:
    """Mirror of ``smem_bytes`` in the CUDA source."""
    return 4 * (group * d + _WARPS * group * d + 2 * _WARPS * group)


def _check(q, k, v, ints, layout: str):
    """What both kernels need: q (B,H,D) and k/v 4-d caches (paged pools
    or dense rows, ``layout`` names them) of q's dtype with D in the
    last axis and Hkv in the second; ``ints`` the int32 (B, ...) index
    tensors (lengths, tables) by name; all contiguous, on q's device."""
    dev = q.device
    named = (("k", k), ("v", v)) + tuple(ints.items())
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype}: kernel takes float32/bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k/v must have q's dtype")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"want q (B,H,D) and k/v {layout}")
    b, h, d = q.shape
    hkv = k.shape[1]
    if v.shape != k.shape or k.shape[3] != d:
        raise ValueError("k/v must match and share q's head dim")
    if h % hkv or h // hkv > _MAX_GROUP or d > 256 or d < 1:
        raise ValueError(f"need H % Hkv == 0, H/Hkv <= {_MAX_GROUP} and "
                         f"D <= 256 (H={h}, Hkv={hkv}, D={d})")
    for name, t in ints.items():
        if t.dtype != torch.int32 or t.dim() < 1 or t.shape[0] != b:
            raise ValueError(f"{name} must be int32 with q's batch first")
    for name, t in (("q", q),) + named:
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
    _check(q, k_pages, v_pages, {"block_tables": block_tables,
                                 "kv_lengths": kv_lengths},
           "pools (P,Hkv,ps,D)")
    if block_tables.dim() != 2 or kv_lengths.dim() != 1:
        raise ValueError("want block_tables (B,T) and kv_lengths (B,)")
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


def decode_attention(q, k, v, kv_lengths, *, scale=None,
                     length_aware: bool = True):
    """Decode attention over a dense per-lane cache.

    q: (B, H, D); k/v: (B, Hkv, S, D); kv_lengths: (B,) int32.  Returns
    (B, H, D) in q's dtype; positions at or past a lane's length
    (clamped to S) do not count, and a lane of length 0 gives 0.

    ``length_aware=True`` (K3) reads only the live positions;
    ``length_aware=False`` (K6a) streams all S positions of every lane
    and masks the dead ones -- the reference's parity and traffic
    baseline; both give the same values.  The reference's key-block
    size ``bk`` is a TPU tiling knob and has no counterpart here: the
    kernel walks the cache by position and takes any S.
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, {"kv_lengths": kv_lengths}, "(B,Hkv,S,D)")
    if k.shape[0] != q.shape[0] or k.shape[2] < 1 or kv_lengths.dim() != 1:
        raise ValueError("want k/v (B,Hkv,S,D) with S >= 1 and "
                         "kv_lengths (B,)")
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = load("decode_attention_dense")
    fn = lib.decode_attention_dense_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_lengths.data_ptr(), out.data_ptr(), b, h, hkv, s, d,
                scale, 0 if length_aware else 1, _DTYPE_CODE[q.dtype],
                stream)
    if rc != 0:
        raise KernelLaunchError(f"decode_attention (length_aware="
                                f"{length_aware}): CUDA error {rc}")
    (COUNTER_LENGTHAWARE if length_aware else COUNTER_MASKED).n += 1
    return out
