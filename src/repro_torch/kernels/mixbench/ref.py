"""Plain PyTorch version of the mixbench sweep kernel (K8)."""

from __future__ import annotations

import torch

__all__ = ["mixbench_ref", "constants"]


def constants(dtype: torch.dtype):
    """(a, b) = (0.999, 1e-3) rounded to ``dtype``, as Python floats
    (exact: each is a value of ``dtype``)."""
    return (torch.tensor(0.999, dtype=dtype).item(),
            torch.tensor(1e-3, dtype=dtype).item())


def mixbench_ref(x: torch.Tensor, iters: int,
                 variant: str = "mul_add") -> torch.Tensor:
    """``iters`` steps of ``y = y * a + b`` in x's dtype, eagerly.

    ``mul_add``: the multiply and the add are separate ops, each rounded
    to x's dtype.  ``fma``: each step rounded once, as a fused
    multiply-add rounds it -- the product of two values of x's dtype is
    exact in the next wider type (float64 for float32, float32 for
    bfloat16), where the add is taken before the one rounding back."""
    a, b = constants(x.dtype)
    if variant == "mul_add":
        a, b = (torch.tensor(c, dtype=x.dtype, device=x.device)
                for c in (a, b))
        y = x
        for _ in range(iters):
            y = y * a + b
        return y
    if variant != "fma":
        raise ValueError(f"unknown variant {variant!r}")
    wide = torch.float64 if x.dtype == torch.float32 else torch.float32
    y = x
    for _ in range(iters):
        y = (y.to(wide) * a + b).to(x.dtype)
    return y
