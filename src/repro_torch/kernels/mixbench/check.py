"""K8 held against its plain version on the card: the cases and the
rule that ``chip_smoke.py`` and the cuda-marked test both apply.

The rule: float32 ``mul_add`` and both bfloat16 arms equal the plain
version bit for bit; float32 ``fma`` may differ by at most 1e-6, the
plain version's double rounding through float64.  (A bfloat16 product
is exact in float32, so the plain bfloat16 ``fma`` rounds once, as
HFMA2 does.)

The cases reach every path of the kernel.  Its grid is capped at 8
blocks of 256 threads per SM, about 270k threads on a 132-SM H100:
  * 2^20 elements run whole float4 vectors, one grid-stride pass;
  * 2^22 + 3 run about four vector passes per thread, then a tail;
  * 1000003 run one vector pass and a scalar tail;
  * an unaligned view of 1000003 runs every element on the scalar
    chain, about four grid-stride passes per thread.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels.mixbench.ops import mixbench
from repro_torch.kernels.mixbench.ref import mixbench_ref

__all__ = ["F32_FMA_TOL", "tolerance", "card_cases", "compare",
           "check_on_card"]

F32_FMA_TOL = 1e-6
_N_MULTI = (1 << 22) + 3


def tolerance(dtype: torch.dtype, variant: str) -> float:
    """Max abs error allowed; 0.0 means bit for bit."""
    return F32_FMA_TOL if (dtype == torch.float32 and
                           variant == "fma") else 0.0


def card_cases(dtype: torch.dtype, device) -> List[Tuple[str, torch.Tensor,
                                                         int]]:
    """(name, x, block) for each case above, values in [0, 1]."""
    base = torch.linspace(0, 1, _N_MULTI, device=device).to(dtype)
    return [("one pass", base[:1 << 20], 1024),
            ("passes", base[:_N_MULTI], 1),
            ("tail", base[:1000003], 1),
            ("unaligned", base[1:1000004], 1)]


def compare(out: torch.Tensor, ref: torch.Tensor, variant: str) -> Dict:
    """{max_abs_err, tol, bitwise, ok} of a kernel output against the
    plain version's on the same input."""
    err = float((out.float() - ref.float()).abs().max().item())
    tol = tolerance(ref.dtype, variant)
    same = torch.equal(out, ref)
    ok = out.dtype == ref.dtype and (same if tol == 0.0 else err <= tol)
    return dict(max_abs_err=err, tol=tol, bitwise=same, ok=ok)


def check_on_card(x: torch.Tensor, iters: int, variant: str,
                  block: int = 1) -> Dict:
    """Run the kernel and the plain version on ``x`` and compare."""
    out = mixbench(x, iters=iters, variant=variant, block=block)
    ref = mixbench_ref(x, iters, variant)
    torch.cuda.synchronize(x.device)
    return compare(out, ref, variant)
