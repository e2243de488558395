"""Wrapper for the mixbench kernel (K8) and the modeled sweep (C1).

``mixbench(x, iters=, variant=)`` runs the intensity-sweep kernel: a
CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/mixbench.cu`` (``fma``: fused multiply-add; ``mul_add``: a
separate multiply and add, the paper's ``-fmad=false``) or raises --
there is no fallback on the card.

``sweep_points`` is the reference's modeled roofline sweep
(throughput per ``iters`` for one profile's precision and path); the
kernel is what measures the same curve on the card.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from repro_torch.core.device_profile import DeviceProfile, Path
from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        load)
from repro_torch.kernels.mixbench.ref import constants, mixbench_ref

__all__ = ["mixbench", "sweep_points", "arithmetic_intensity",
           "VARIANTS", "COUNTER_FMA", "COUNTER_MUL_ADD"]

VARIANTS = ("fma", "mul_add")
COUNTER_FMA = LaunchCounter("mixbench_fma")
COUNTER_MUL_ADD = LaunchCounter("mixbench_mul_add")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mixbench(x: torch.Tensor, *, iters: int = 64, variant: str = "fma",
             block: int = 1024) -> torch.Tensor:
    """``iters`` dependent steps ``y = y * a + b`` per element of the
    flat array ``x`` (a = 0.999, b = 1e-3 in x's dtype).

    ``block`` is the reference's tile and a contract check only (``n``
    must be a multiple of ``min(block, n)``); the CUDA kernel walks the
    array grid-stride."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    (n,) = x.shape
    block = min(block, n)
    assert n % block == 0, (n, block)
    if x.device.type == "cpu":
        return mixbench_ref(x, iters, variant)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype}: kernel takes float32/bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if iters < 0:
        raise ValueError(f"iters {iters} < 0")
    out = torch.empty_like(x)
    a, b = constants(x.dtype)
    fn = load("mixbench").mixbench_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), n, iters, a, b,
                int(variant == "fma"), _DTYPE_CODE[x.dtype], n_sm, stream)
    if rc != 0:
        raise KernelLaunchError(f"mixbench ({variant}): CUDA error {rc}")
    (COUNTER_FMA if variant == "fma" else COUNTER_MUL_ADD).n += 1
    return out


def arithmetic_intensity(iters: int, dtype=torch.float32) -> float:
    """Flops per byte of one element's read: ``2 * iters / itemsize``."""
    return 2.0 * iters / torch.empty((), dtype=dtype).element_size()


def sweep_points(profile: DeviceProfile, precision: str, path: Path,
                 iters_list=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
                 dtype_bytes: int = 4) -> List[Dict[str, float]]:
    """Modeled roofline sweep: throughput(iters) for one (precision, path).

    At low intensity the point sits on the bandwidth roof, at high
    intensity on the path's compute roof -- with the CMP 170HX's crippled
    FMA path the compute roof is 0.39 TFLOPS and the knee moves far right;
    the mul_add path restores it to 6.2 (paper Graph 3-1).
    """
    peak = profile.throughput(precision, path) * 1e12
    bw = profile.hbm_bw_gbps * 1e9
    out = []
    for iters in iters_list:
        ai = 2.0 * iters / dtype_bytes
        gflops = min(peak, ai * bw)
        out.append({
            "compute_iters": iters,
            "flops_per_byte": ai,
            "gflops": gflops / 1e9,
            "gbps": gflops / ai / 1e9,
        })
    return out
