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
    sums reduced over them.  Where ``w_down``'s rows are not stored over
    the axes of ``w_gate``'s columns, every weight is read whole and
    nothing is split: a moe block's shared expert in train mode, which
    the reference stores by the experts' rule (d over ``model``, d_ff
    over the batch axes)."""
    axes = sharding.axes_of(p.w_gate, 1)
    paired = sharding.axes_of(p.w_down, 0) == axes
    axes, col = (axes, ...) if paired else ((), None)
    x = sharding.copy_in(x, axes)
    g = torch.matmul(x, sharding.weight(p.w_gate, None, col))
    u = torch.matmul(x, sharding.weight(p.w_up, None, col))
    h = F.silu(g.float()).to(x.dtype) * u
    return sharding.reduce_out(
        torch.matmul(h, sharding.weight(p.w_down, col, None)), axes)


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
    in float32 and is rounded to the compute dtype, as the reference.

    On a mesh the first product is column-parallel over the axes d_ff is
    stored over (``b1`` stored so too, added to the local block), the
    second row-parallel, its partial sums reduced over them; ``b2``,
    stored whole, is added once after the reduction."""
    axes = sharding.axes_of(p.w1, 1)
    x = sharding.copy_in(x, axes)
    h = torch.matmul(x, sharding.weight(p.w1, None, ...)) + \
        sharding.weight(p.b1, ...)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return sharding.reduce_out(
        torch.matmul(h, sharding.weight(p.w2, ..., None)), axes) + \
        sharding.weight(p.b2, None)
