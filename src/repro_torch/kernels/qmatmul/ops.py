"""Wrappers for the quantized matmul (K7) and its variant choice (C4).

On a profile with an unthrottled int8 path and a throttled f32 path (the
CMP 170HX), ``select_variant`` picks ``dot_i8`` for q8_0 weights; on a
TPU it also picks ``dot_i8``; formats without an int8 plane take
``dequant_dot``.  ``qmatmul_variant`` runs one variant: a CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/qmatmul.cu`` or raises -- there is no fallback on the card.
There, both variants run on the tensor cores: a first launch splits x
into bf16 parts and sums it per sub-block (``dequant_dot``) or
quantizes it (``dot_i8``) into scratch this wrapper allocates, then the
products stream the weight planes in equal runs, one CTA per SM
(:func:`qmatmul_plan`), and a third launch adds the pieces of the tiles
no run holds whole from an f32 workspace, in run order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.device_profile import DeviceProfile, Path
from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        bind)
from repro_torch.kernels.qmatmul.ref import qmatmul_i8_ref, qmatmul_ref
from repro_torch.quant.quantize import PLANES, QTensor, plane_layout

__all__ = ["qmatmul", "qmatmul_variant", "qmatmul_plan", "select_variant",
           "VARIANTS", "TILES", "COUNTER_DEQUANT_DOT", "COUNTER_DOT_I8"]

VARIANTS = ("dequant_dot", "dot_i8")
COUNTER_DEQUANT_DOT = LaunchCounter("qmatmul_dequant_dot")
COUNTER_DOT_I8 = LaunchCounter("qmatmul_dot_i8")
_FMT_CODE = {"q8_0": 0, "q6_k": 1, "q4_k": 2, "q2_k": 3}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the CUDA kernels' tiles, (variant, M > 16) -> (BM, BN, BK): rows,
#: columns and K a stage (``DqSmall``, ``DqLarge``, ``I8Small``,
#: ``I8Large`` in ``csrc/qmatmul.cu``)
TILES = {("dequant_dot", False): (16, 256, 64),
         ("dequant_dot", True): (128, 128, 32),
         ("dot_i8", False): (16, 256, 64),
         ("dot_i8", True): (128, 128, 64)}
#: ``qmatmul_fwd``'s argument types: x, the five planes, out, x's
#: scratch, its sums (or scales), the workspace; its size; M, K, N,
#: format, variant, x dtype, runs, vec; the stream
_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
         + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def qmatmul_plan(m: int, k: int, n: int, variant: str, sms: int) -> tuple:
    """(runs, slots, slot rows, tile columns) of the products' launch for
    (m, k, n): the K steps of all tiles are cut into ``runs`` equal runs,
    one CTA each, one per SM (fewer if there are fewer steps); a run that
    holds a piece of a tile, not all of it, writes it to slot run + tile
    of an f32 workspace of ``slots`` x slot rows x tile columns."""
    bm, bn, bk = TILES[variant, m > 16]
    tiles = -(-m // bm) * -(-n // bn)
    runs = min(sms, tiles * -(-k // bk))
    return runs, runs + tiles - 1, min(m, bm), bn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    dev = x.device
    runs, slots, slot_rows, tile_n = qmatmul_plan(
        m, k, n, variant, _sm_count(dev.index))
    mp = -(-m // 4) * 4
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = torch.empty(slots * slot_rows * tile_n, dtype=torch.float32,
                     device=dev)
    # x's scratch: int8 x and its scales (dot_i8); three bf16 parts of
    # f32 x, and x's sums per sub-block for the formats with mins
    if variant == "dot_i8":
        xbuf = torch.empty((m, k), dtype=torch.int8, device=dev)
        xsum = torch.empty((k // 32, mp), dtype=torch.float32, device=dev)
    else:
        xbuf = (torch.empty((3, m, k), dtype=torch.bfloat16, device=dev)
                if x.dtype == torch.float32 else None)
        xsum = (torch.empty((k // fmt.sub_block, mp), dtype=torch.float32,
                            device=dev) if fmt.asymmetric else None)
    planes = [x] + [getattr(qt, name) for name in PLANES]
    vec = int(n % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in planes
                                  if t is not None))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = bind("qmatmul", "qmatmul_fwd", _ARGS)(
            x.data_ptr(), qt.values.data_ptr(), _ptr(qt.sub_scales),
            _ptr(qt.sub_mins), qt.super_scales.data_ptr(),
            _ptr(qt.super_mins), out.data_ptr(), _ptr(xbuf), _ptr(xsum),
            ws.data_ptr(), ws.numel(), m, k, n,
            _FMT_CODE[qt.fmt], VARIANTS.index(variant),
            _DTYPE_CODE[x.dtype], runs, vec, stream)
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
