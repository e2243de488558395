"""Wrappers for the path-selectable matmul (K9) and its policy dispatch
(paper C2).

``matmul(x, w, policy=...)`` consults the
:class:`~repro_torch.core.compute_path.PathPolicy` for a device profile
and runs the variant it picks -- the framework-level equivalent of the
paper's "recompile with -fmad=false".  ``matmul_variant`` runs one
variant: a CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches ``csrc/fma_matmul.cu`` or raises -- there is no
fallback on the card.  ``mxu`` runs on the tensor cores; ``mul_add`` is
a separate multiply and add per term on the CUDA cores.  Each variant
runs one of two kernels, chosen by shape:

* the weight stream where TMA can read x and w (:func:`stream_rows`):
  a TMA-fed ring, the K blocks of all tiles cut into one equal run per
  SM (:func:`stream_plan`), pieces of tiles added from an f32
  workspace that this wrapper allocates; the product is ``mma.sync``
  (counter ``fma_matmul_mxu``) or register-tiled FMUL and FADD
  (counter ``fma_matmul_mul_add``);
* else a kernel that stages 64 x 64 tiles element by element: WMMA
  (counter ``fma_matmul_mxu_wmma``) or FMUL and FADD (counter
  ``fma_matmul_mul_add_staged``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.compute_path import PathPolicy, matmul_descriptor
from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        load)
from repro_torch.kernels.fma_matmul.ref import matmul_ref

__all__ = ["matmul", "matmul_variant", "policy_variant", "stream_plan",
           "stream_rows", "VARIANTS", "COUNTER_MXU", "COUNTER_MXU_WMMA",
           "COUNTER_MUL_ADD", "COUNTER_MUL_ADD_STAGED"]

VARIANTS = ("mxu", "mul_add")
COUNTER_MXU = LaunchCounter("fma_matmul_mxu")
COUNTER_MXU_WMMA = LaunchCounter("fma_matmul_mxu_wmma")
COUNTER_MUL_ADD = LaunchCounter("fma_matmul_mul_add")
COUNTER_MUL_ADD_STAGED = LaunchCounter("fma_matmul_mul_add_staged")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the C entry's kernel codes and the counters of its launches:
#: variant -> (weight stream, staged kernel)
_KERNELS = {"mxu": ((0, COUNTER_MXU), (2, COUNTER_MXU_WMMA)),
            "mul_add": ((1, COUNTER_MUL_ADD), (3, COUNTER_MUL_ADD_STAGED))}
#: the weight stream's tile (``SBM``, ``SBN``) and each arm's K per
#: stage (``Arm::kBK``) in ``csrc/fma_matmul.cu``
STREAM_BM, STREAM_BN = 128, 256
STREAM_BK = {"mxu": {torch.float32: 32, torch.bfloat16: 64},
             "mul_add": {torch.float32: 32, torch.bfloat16: 32}}
#: the precision names the profiles use; the reference maps
#: ``str(x.dtype)`` ("float32", ...) the same way, anything else to "f32"
_PRECISION = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16"}


def stream_plan(m: int, k: int, n: int, dtype: torch.dtype,
                sms: int, variant: str = "mxu") -> tuple:
    """(runs, workspace slots) of the weight stream for (m, k, n): the
    K blocks (the arm's K per stage) of all 128 x 256 tiles are cut
    into ``runs`` equal runs, one CTA each, one per SM (fewer if there
    are fewer blocks); a run that holds a piece of a tile, not all of
    it, writes the piece to slot run + tile of an f32 workspace of
    ``slots`` x min(m, 128) x 256."""
    tiles = -(-m // STREAM_BM) * -(-n // STREAM_BN)
    iters = tiles * -(-k // STREAM_BK[variant][dtype])
    runs = min(sms, iters)
    return runs, runs + tiles - 1


def stream_rows(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether TMA can read x and w: every row whole 16-byte chunks (K
    and N multiples of 4 in float32, of 8 in bfloat16: the tensor maps'
    row strides) and both bases 16-byte aligned."""
    per = 16 // x.element_size()
    return (x.shape[1] % per == 0 and w.shape[1] % per == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fwd():
    """``fma_matmul_fwd`` of the built library, its argument types set."""
    fn = load("fma_matmul").fma_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    runs, ws = 1, None
    stream, staged = _KERNELS[variant]
    if stream_rows(x, w):
        code, counter = stream
        runs, slots = stream_plan(m, k, n, x.dtype,
                                  _sm_count(x.device.index), variant)
        ws = torch.empty((slots, min(m, STREAM_BM), STREAM_BN),
                         dtype=torch.float32, device=x.device)
    else:
        code, counter = staged
    with torch.cuda.device(x.device):
        rc = _fwd()(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr(), m, k, n, code,
                    _DTYPE_CODE[x.dtype], runs,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(f"fma_matmul ({variant}): CUDA error {rc}")
    counter.n += 1
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
