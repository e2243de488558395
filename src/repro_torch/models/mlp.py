"""SwiGLU feed-forward block (the reference's ``models/mlp.py:swiglu``)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.common import frozen


class SwiGLU(nn.Module):
    """w_gate/w_up (d_model, d_ff), w_down (d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()

        def z(*shape):
            return frozen(torch.zeros(shape, dtype=dtype, device=device))

        self.w_gate = z(d_model, d_ff)
        self.w_up = z(d_model, d_ff)
        self.w_down = z(d_ff, d_model)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, p.w_gate)
    u = torch.matmul(x, p.w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, p.w_down)
