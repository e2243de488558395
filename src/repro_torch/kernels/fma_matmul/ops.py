"""Wrappers for the path-selectable matmul (K9) and its policy dispatch
(paper C2).

``matmul(x, w, policy=...)`` consults the
:class:`~repro_torch.core.compute_path.PathPolicy` for a device profile
and runs the variant it picks -- the framework-level equivalent of the
paper's "recompile with -fmad=false".  ``matmul_variant`` runs one
variant: a CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches ``csrc/fma_matmul.cu`` (``mxu``: tensor cores;
``mul_add``: a separate multiply and add per term on the CUDA cores)
or raises -- there is no fallback on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.compute_path import PathPolicy, matmul_descriptor
from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        load)
from repro_torch.kernels.fma_matmul.ref import matmul_ref

__all__ = ["matmul", "matmul_variant", "policy_variant", "VARIANTS",
           "COUNTER_MXU", "COUNTER_MUL_ADD"]

VARIANTS = ("mxu", "mul_add")
COUNTER_MXU = LaunchCounter("fma_matmul_mxu")
COUNTER_MUL_ADD = LaunchCounter("fma_matmul_mul_add")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the precision names the profiles use; the reference maps
#: ``str(x.dtype)`` ("float32", ...) the same way, anything else to "f32"
_PRECISION = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16"}


def matmul_variant(x: torch.Tensor, w: torch.Tensor, *,
                   variant: str = "mxu", bm: int = 128, bk: int = 128,
                   bn: int = 128) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32 through one compute path.

    The blocks are the reference's tiles and a contract check only:
    each dimension must be a multiple of its block clamped to it.  The
    CUDA kernel picks its own tiles and takes x and w both float32 or
    both bfloat16."""
    m, k = x.shape
    k2, n = w.shape
    assert k == k2, (tuple(x.shape), tuple(w.shape))
    bm, bk, bn = min(bm, m), min(bk, k), min(bn, n)
    assert m % bm == 0 and k % bk == 0 and n % bn == 0, (
        f"shape ({m},{k},{n}) not divisible by blocks ({bm},{bk},{bn})")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, w {w.dtype}: the kernel takes both "
                        "float32 or both bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = load("fma_matmul").fma_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                VARIANTS.index(variant), _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise KernelLaunchError(f"fma_matmul ({variant}): CUDA error {rc}")
    (COUNTER_MXU if variant == "mxu" else COUNTER_MUL_ADD).n += 1
    return out


def policy_variant(x: torch.Tensor, w: torch.Tensor,
                   policy: Optional[PathPolicy]) -> str:
    """The variant :func:`matmul` runs for these operands: ``mxu`` with
    no policy, else the one whose path the policy models fastest for
    this shape and x's precision (its ``fma`` is the matrix unit)."""
    if policy is None:
        return "mxu"
    m, k = x.shape
    n = w.shape[1]
    desc = matmul_descriptor(m, n, k, _PRECISION.get(x.dtype, "f32"),
                             supports=("fma", "mul_add"))
    return "mxu" if policy.decide(desc).variant == "fma" else "mul_add"


def matmul(x: torch.Tensor, w: torch.Tensor,
           policy: Optional[PathPolicy] = None) -> torch.Tensor:
    """Path-policy-dispatched matmul.

    With no policy (or a TPU or A100 profile) this takes the tensor-core
    path; with a CMP-170HX-style profile whose fused path is throttled
    for the activation precision, the policy reroutes onto the separate
    multiply and add."""
    return matmul_variant(x, w, variant=policy_variant(x, w, policy))
