"""Plain PyTorch version of the path-selectable matmul (K9), both
variants: one float32 matrix product (on the card TF32 must be off,
``torch.backends.cuda.matmul.allow_tf32 = False``, for it to be one)."""

from __future__ import annotations

import torch

__all__ = ["matmul_ref"]


def matmul_ref(x: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (x.float() @ w.float()).to(out_dtype)
