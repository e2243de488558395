"""Wrappers for the decode attention kernels: paged (K1; K4 over int8
pools) and dense length-aware (K3; K5 over an int8 cache) / masked
(K6a; K6b over an int8 cache).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches ``csrc/decode_attention_paged.cu`` or
``csrc/decode_attention_dense.cu`` or raises -- there is no fallback on
the card.  Both sources instantiate one split-KV body
(``csrc/decode_split.cuh``) for a cache in q's dtype and for an int8
cache with f32 scales along the key axis (``qblock`` keys per scale);
they differ only in where a lane's row ``pos`` lives (a dense row, or
row ``pos % ps`` of page ``block_tables[b, pos // ps]``).  The kernels
cut a lane's positions into chunks (:func:`split_plan`), one CTA each,
and merge the chunks' partials in the same launch; the wrapper gives
them a workspace (``torch.empty`` per call) and per-head counters
(zeroed once, cached per device and stream, left at 0 by every launch,
never freed).

A ``meta`` tensor (the dry run's shape-only pass,
:mod:`repro_torch.launch.dryrun`) in :func:`decode_attention` takes the
blockwise attention over every position of the cache (the dry run's
cache is full), so the pass counts the products the kernel does with no
float64 temporaries; any other device but ``cpu`` and ``cuda`` is
refused.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        bind)
from repro_torch.kernels.flash_attention.blockwise import blockwise_attention
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_q8_ref, decode_attention_paged_ref,
    decode_attention_q8_ref, decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_paged",
           "decode_attention_q8", "decode_attention_paged_q8",
           "kv_blocks_fetched", "kv_pages_fetched", "split_plan",
           "COUNTER", "COUNTER_LENGTHAWARE", "COUNTER_MASKED",
           "COUNTER_PAGED_Q8", "COUNTER_Q8_LENGTHAWARE", "COUNTER_Q8_MASKED"]

COUNTER = LaunchCounter("decode_attention_paged")
COUNTER_LENGTHAWARE = LaunchCounter("decode_attention_lengthaware")
COUNTER_MASKED = LaunchCounter("decode_attention_masked")
COUNTER_PAGED_Q8 = LaunchCounter("decode_attention_paged_q8")
COUNTER_Q8_LENGTHAWARE = LaunchCounter("decode_attention_q8_lengthaware")
COUNTER_Q8_MASKED = LaunchCounter("decode_attention_q8_masked")
_MAX_GROUP = 64                    # csrc: MAX_GROUP
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: SMs of an H100 SXM: the split aims to give each at least one CTA
SMS = 132
#: chunk lengths the kernels take (csrc: ch)
CHUNKS = (32, 64)
_PAGED_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_DENSE_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
#: key block of :func:`decode_attention`'s meta arm
META_BLOCK = 512
#: {(device index, stream handle): int32 counters, one per (lane, kv head)}
_COUNTERS = {}
#: counters outgrown by a wider launch: a CUDA graph captured with them
#: still points there, so they are kept, never freed
_OUTGROWN = []


def split_plan(s: int, b: int, hkv: int) -> tuple:
    """(CH, n_chunks) of the split kernels' grid (B * Hkv, n_chunks): a
    CTA per chunk of CH consecutive positions, chunk c holding positions
    [c CH, min((c + 1) CH, S)); S is a lane's positions (paged: T ps).
    A function of the shapes alone, so the launch needs no length from
    the device: CH is 64 where that still gives every SM a CTA, else 32
    (short caches, few lanes)."""
    if s < 1 or b < 1 or hkv < 1:
        raise ValueError(f"need S, B, Hkv >= 1 (got {s}, {b}, {hkv})")
    ch = CHUNKS[1] if b * hkv * -(-s // CHUNKS[1]) >= SMS else CHUNKS[0]
    return ch, -(-s // ch)


def kv_blocks_fetched(kv_lengths, sk: int, bk: int = 512) -> np.ndarray:
    """The reference's modeled key-block fetch count per lane of its
    length-aware dense kernel: a lane of length L reads ``max(ceil(L /
    bk), 1)`` blocks of ``min(bk, sk)`` keys (a dead lane still reads
    block 0; the masked kernel reads ``sk / bk`` for every lane).  An
    int64 array shaped like ``kv_lengths``, the contract a decode cost
    model counts bytes with; the port's split kernels read a lane's
    chunks (:func:`split_plan`) instead."""
    lens = np.asarray(kv_lengths)
    bk = min(bk, sk)
    return np.maximum(-(-lens // bk), 1).astype(np.int64)


def kv_pages_fetched(kv_lengths, bt_width: int, page_size: int
                     ) -> np.ndarray:
    """The reference's modeled page fetch count per lane of its paged
    kernels, following the block table: ``clip(ceil(L / page_size), 1,
    bt_width)`` pages for a lane of length L -- :func:`kv_blocks_fetched`
    when ``page_size == bk``, the paged-vs-dense bytes-a-token parity."""
    lens = np.asarray(kv_lengths)
    return np.clip(-(-lens // page_size), 1, bt_width).astype(np.int64)


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters at 0 for launches on ``stream``;
    the kernels leave them at 0, so they are zeroed only when made.  A
    CUDA graph's launches keep the address they were captured with, so
    the counters of its capture stream must exist before the capture
    (the serving engine's first dispatch of a size runs eagerly on that
    stream) and are never freed."""
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        if c is not None:
            _OUTGROWN.append(c)
        c = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def _on_cpu(q) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA one
    (kernel); anything else is refused."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return False


def _check(q, k, v, ints, layout: str, kv_dtype=None):
    """What every kernel needs: q (B,H,D) and k/v 4-d caches (paged pools
    or dense rows, ``layout`` names them) of ``kv_dtype`` (default q's)
    with D in the last axis and Hkv in the second; ``ints`` the int32
    (B, ...) index tensors (lengths, tables) by name; all contiguous, on
    q's device."""
    dev = q.device
    named = (("k", k), ("v", v)) + tuple(ints.items())
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype}: kernel takes float32/bfloat16")
    kv_dtype = kv_dtype or q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"k/v must be {kv_dtype}")
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


def _check_q8(q, k_q, k_scale, v_q, v_scale, ints, layout: str,
              qblock: int):
    """:func:`_check` for int8 k/v, plus their f32 scales: shape
    ``(k.shape[0], Hkv, rows/qblock, 1)`` where ``rows`` is the key
    axis the scales run along (S dense, ps paged), ``rows % qblock ==
    0``, contiguous, on q's device."""
    _check(q, k_q, v_q, ints, layout, kv_dtype=torch.int8)
    rows = k_q.shape[2]
    if qblock < 1 or rows % qblock:
        raise ValueError(f"qblock {qblock} must divide the key axis "
                         f"({rows})")
    want = (k_q.shape[0], k_q.shape[1], rows // qblock, 1)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _split_launch(name, source, symbol, argtypes, q, k, v, s, args):
    """One launch of a split kernel over S = ``s`` positions a lane:
    refuses what it cannot read (D % 16, pools or caches off a 16-byte
    boundary), plans the chunks, allocates the output and the workspace,
    and calls ``symbol`` of ``source`` with ``args(out, ws_ml, ws_acc,
    counters, ch)`` and the stream."""
    b, h, d = q.shape
    hkv = k.shape[1]
    if d % 16:
        raise ValueError(f"head dim {d}: the split kernels copy rows in "
                         "16-byte pieces and need D % 16 == 0")
    for nm, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{nm} must start on a 16-byte boundary")
    ch, n_chunks = split_plan(s, b, hkv)
    out = torch.empty_like(q)
    slots = b * hkv * n_chunks * (h // hkv)
    ws = torch.empty(slots * (d + 2), dtype=torch.float32, device=q.device)
    fn = bind(source, symbol, argtypes)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(q.device, stream, b * hkv)
        rc = fn(*args(out, ws.data_ptr() + 4 * slots * d, ws.data_ptr(),
                      counters.data_ptr(), ch), stream)
    if rc != 0:
        raise KernelLaunchError(f"{name}: CUDA error {rc}")
    return out


def _launch_paged(name, q, kp, ksp, vp, vsp, bt, lens, scale, qblock):
    """One launch of the paged split kernel; ``ksp is None`` selects the
    instantiation over pools in q's dtype (K1), else int8 (K4)."""
    if bt.dim() != 2 or bt.shape[1] < 1 or lens.dim() != 1:
        raise ValueError("want block_tables (B,T) with T >= 1 and "
                         "kv_lengths (B,)")
    b, h, d = q.shape
    hkv, ps = kp.shape[1], kp.shape[2]
    t = bt.shape[1]
    return _split_launch(
        name, "decode_attention_paged", "decode_attention_paged_fwd",
        _PAGED_ARGS, q, kp, vp, t * ps,
        lambda out, ws_ml, ws_acc, counters, ch: (
            q.data_ptr(), kp.data_ptr(), _ptr(ksp), vp.data_ptr(), _ptr(vsp),
            bt.data_ptr(), lens.data_ptr(), out.data_ptr(), ws_ml, ws_acc,
            counters, b, h, hkv, ps, d, t, qblock, ch, scale,
            int(ksp is not None), _DTYPE_CODE[q.dtype]))


def _launch_dense(name, q, k, ks, v, vs, lens, scale, qblock, length_aware):
    """One launch of the dense split kernel; ``ks is None`` selects the
    instantiation over a cache in q's dtype (K3/K6a), else int8
    (K5/K6b)."""
    if k.shape[0] != q.shape[0] or k.shape[2] < 1 or lens.dim() != 1:
        raise ValueError("want k/v (B,Hkv,S,D) with S >= 1 and "
                         "kv_lengths (B,)")
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    return _split_launch(
        f"{name} (length_aware={length_aware})", "decode_attention_dense",
        "decode_attention_dense_fwd", _DENSE_ARGS, q, k, v, s,
        lambda out, ws_ml, ws_acc, counters, ch: (
            q.data_ptr(), k.data_ptr(), _ptr(ks), v.data_ptr(), _ptr(vs),
            lens.data_ptr(), out.data_ptr(), ws_ml, ws_acc, counters, b, h,
            hkv, s, d, qblock, ch, scale, 0 if length_aware else 1,
            int(ks is not None), _DTYPE_CODE[q.dtype]))


def decode_attention_paged(q, k_pages, v_pages, block_tables, kv_lengths,
                           *, scale=None):
    """Block-table decode attention over a global page pool (K1).

    q: (B, H, D); k_pages/v_pages: (P, Hkv, ps, D); block_tables: (B, T)
    int32 physical page ids in logical order; kv_lengths: (B,) int32.
    Returns (B, H, D) in q's dtype.  Positions at or past a lane's
    length (clamped to T*ps), and their table slots, are never read; a
    lane of length 0 gives 0.  The kernel cuts the lane's T*ps positions
    into chunks (:func:`split_plan`) whatever the page size; D must be a
    multiple of 16.
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if _on_cpu(q):
        return decode_attention_paged_ref(q, k_pages, v_pages, block_tables,
                                          kv_lengths, scale=scale)
    _check(q, k_pages, v_pages, {"block_tables": block_tables,
                                 "kv_lengths": kv_lengths},
           "pools (P,Hkv,ps,D)")
    out = _launch_paged("decode_attention_paged", q, k_pages, None, v_pages,
                        None, block_tables, kv_lengths, scale, 1)
    COUNTER.n += 1
    return out


def decode_attention_paged_q8(q, k_pages, k_scale_pages, v_pages,
                              v_scale_pages, block_tables, kv_lengths, *,
                              scale=None, qblock: int = 32):
    """Block-table decode attention over int8 page pools (K4).

    k_pages/v_pages: (P, Hkv, ps, D) int8; k_scale_pages/v_scale_pages:
    (P, Hkv, ps/qblock, 1) f32, one scale per ``qblock`` consecutive
    positions of a page, found through the same block-table entry as
    the values.  Otherwise as :func:`decode_attention_paged`.  The
    model's per-(token, head) scale pools are ``qblock=1``.
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if _on_cpu(q):
        return decode_attention_paged_q8_ref(
            q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_tables,
            kv_lengths, scale=scale, qblock=qblock)
    _check_q8(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
              {"block_tables": block_tables, "kv_lengths": kv_lengths},
              "pools (P,Hkv,ps,D)", qblock)
    out = _launch_paged("decode_attention_paged_q8", q, k_pages,
                        k_scale_pages, v_pages, v_scale_pages, block_tables,
                        kv_lengths, scale, qblock)
    COUNTER_PAGED_Q8.n += 1
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
    baseline; both give the same bits.  The reference's key-block size
    ``bk`` is a TPU tiling knob and has no counterpart here: the kernel
    cuts the cache into chunks of its own (:func:`split_plan`) and takes
    any S; D must be a multiple of 16.
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "meta":
        s = k.shape[2]
        return blockwise_attention(q[:, :, None], k, v, causal=False,
                                   scale=scale,
                                   block=META_BLOCK if s % META_BLOCK == 0
                                   else s)[:, :, 0]
    if _on_cpu(q):
        return decode_attention_ref(q, k, v, kv_lengths, scale=scale)
    _check(q, k, v, {"kv_lengths": kv_lengths}, "(B,Hkv,S,D)")
    out = _launch_dense("decode_attention", q, k, None, v, None, kv_lengths,
                        scale, 1, length_aware)
    (COUNTER_LENGTHAWARE if length_aware else COUNTER_MASKED).n += 1
    return out


def decode_attention_q8(q, k_q, k_scale, v_q, v_scale, kv_lengths, *,
                        scale=None, qblock: int = 32,
                        length_aware: bool = True):
    """Decode attention over a dense int8 cache (K5; K6b with
    ``length_aware=False``).

    k_q/v_q: (B, Hkv, S, D) int8; k_scale/v_scale: (B, Hkv, S/qblock, 1)
    f32, one scale per ``qblock`` consecutive positions.  Otherwise as
    :func:`decode_attention`; K5 reads values and scales of live
    positions only, K6b streams all S and gives the same values.  The
    model's per-(token, head) scales are ``qblock=1``.
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if _on_cpu(q):
        return decode_attention_q8_ref(q, k_q, k_scale, v_q, v_scale,
                                       kv_lengths, scale=scale, qblock=qblock)
    _check_q8(q, k_q, k_scale, v_q, v_scale, {"kv_lengths": kv_lengths},
              "(B,Hkv,S,D)", qblock)
    out = _launch_dense("decode_attention_q8", q, k_q, k_scale, v_q, v_scale,
                        kv_lengths, scale, qblock, length_aware)
    (COUNTER_Q8_LENGTHAWARE if length_aware else COUNTER_Q8_MASKED).n += 1
    return out
