"""Feed-forward blocks: SwiGLU (the LM default) and the GELU MLP with
biases (whisper); the reference's ``models/mlp.py``."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.common import frozen
from repro_torch.parallel import sharding


def _zeros(dtype, device):
    def z(*shape):
        return frozen(torch.zeros(shape, dtype=dtype, device=device))
    return z


class SwiGLU(nn.Module):
    """w_gate/w_up (d_model, d_ff), w_down (d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        z = _zeros(dtype, device)
        self.w_gate = z(d_model, d_ff)
        self.w_up = z(d_model, d_ff)
        self.w_down = z(d_ff, d_model)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """On a mesh the gate and up products are column-parallel over the
    axes d_ff is stored over, the down product row-parallel, its partial
    sums reduced over them."""
    axes = sharding.axes_of(p.w_gate, 1)
    x = sharding.copy_in(x, axes)
    g = torch.matmul(x, sharding.weight(p.w_gate, None, ...))
    u = torch.matmul(x, sharding.weight(p.w_up, None, ...))
    h = F.silu(g.float()).to(x.dtype) * u
    return sharding.reduce_out(
        torch.matmul(h, sharding.weight(p.w_down, ..., None)), axes)


class GeluMLP(nn.Module):
    """w1 (d_model, d_ff) with bias b1, w2 (d_ff, d_model) with bias b2
    (zero-initialised, as the reference's ``init_gelu_mlp``)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        z = _zeros(dtype, device)
        self.w1 = z(d_model, d_ff)
        self.b1 = z(d_ff)
        self.w2 = z(d_ff, d_model)
        self.b2 = z(d_model)


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation; the GELU runs
    in float32 and is rounded to the compute dtype, as the reference."""
    h = torch.matmul(x, p.w1) + p.b1
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, p.w2) + p.b2
