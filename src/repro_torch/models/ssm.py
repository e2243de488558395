"""Mamba-2 (SSD, state-space duality) block: chunked prefill + decode step.

Port of the reference's ``models/ssm.py`` (arXiv:2405.21060, scalar A
per head, one B/C group -- the mamba2-780m configuration):

  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T        (state: H x N x P)
  y_t = C_t . h_t + D x_t

The full-sequence pass runs the chunked dual form through
:func:`repro_torch.kernels.ssd_scan.ssd` (K10 on the card, its plain
version on the CPU); decode carries the (H, N, P) state and the conv
window, O(1) per token, in plain PyTorch as the reference does in jnp.

The block follows mamba_ssm's Mamba2: in_proj -> [z | x | B | C | dt],
causal depthwise conv on (x, B, C), SSD, gated RMSNorm, out_proj.  The
two projections are stored in the compute dtype (the values of the
reference's cast at each use); the conv weights, A, dt bias, D and the
norm scale stay float32, as the reference reads them in float32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.ssd_scan import ssd
from repro_torch.models.common import (ModelConfig, SSMConfig, dense_init,
                                       frozen)

__all__ = ["Mamba2", "init_mamba2", "init_mamba2_state", "mamba2_decode",
           "mamba2_forward"]

F32 = torch.float32


def _dims(cfg: ModelConfig):
    """(ssm config, d_inner, SSD heads, conv channels).  The SSD's head
    count is ``d_inner // head_dim`` (48 for mamba2-780m), not
    ``cfg.n_heads``."""
    s = cfg.ssm or SSMConfig()
    d_inner = s.d_inner_override or (s.expand * cfg.d_model)
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim
    return s, d_inner, n_heads, conv_ch


class Mamba2(nn.Module):
    """The reference's parameter names and layouts: ``in_proj`` (d,
    2 d_inner + 2N + nh), ``out_proj`` (d_inner, d), ``conv_w`` (W,
    conv_ch), ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip`` (nh,),
    ``norm_scale`` (d_inner,)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        s, d_inner, nh, conv_ch = _dims(cfg)
        dt = cfg.compute_dtype

        def z(*shape, dtype=F32):
            return frozen(torch.zeros(shape, dtype=dtype, device=device))

        self.in_proj = z(cfg.d_model, 2 * d_inner + 2 * s.state_dim + nh,
                         dtype=dt)
        self.out_proj = z(d_inner, cfg.d_model, dtype=dt)
        self.conv_w = z(s.conv_width, conv_ch)
        self.conv_b = z(conv_ch)
        self.a_log = z(nh)
        self.dt_bias = z(nh)
        self.d_skip = z(nh)
        self.norm_scale = z(d_inner)


@torch.no_grad()
def init_mamba2(p: Mamba2, generator: torch.Generator) -> None:
    """The reference's ``init_mamba2`` scheme, in place: fan-in
    projections, conv weights at scale 0.2, zero conv bias, A from 1 to
    16 over the heads, dt bias ``softplus^-1(0.01)``, unit D and norm."""
    dev = p.in_proj.device
    nh = p.a_log.shape[0]
    p.in_proj.copy_(dense_init(tuple(p.in_proj.shape), generator, dev))
    p.out_proj.copy_(dense_init(tuple(p.out_proj.shape), generator, dev))
    p.conv_w.copy_(dense_init(tuple(p.conv_w.shape), generator, dev,
                              scale=0.2))
    p.conv_b.zero_()
    p.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, dtype=F32,
                                           device=dev)))
    p.dt_bias.fill_(math.log(math.expm1(0.01)))
    p.d_skip.fill_(1.0)
    p.norm_scale.fill_(1.0)


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s, d_inner, nh, _ = _dims(cfg)
    n = s.state_dim
    z, xin, b, c, dt = torch.split(zxbcdt, [d_inner, d_inner, n, n, nh],
                                   dim=-1)
    return z, xin, b, c, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (torch's
    ``F.softplus`` returns x above a threshold instead)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gated_norm(p: Mamba2, y: torch.Tensor, z: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)`` in float32: divide by the rms, then
    scale, in the reference's order."""
    yf = y.to(F32) * F.silu(z.to(F32))
    rms = torch.sqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf / rms * p.norm_scale).to(y.dtype)


def mamba2_forward(p: Mamba2, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model), the chunked SSD on K10."""
    s_cfg, d_inner, nh, _ = _dims(cfg)
    bsz, s, _ = x.shape
    zxbcdt = torch.matmul(x, p.in_proj)
    z, xin, b, c, dt = _split_in_proj(zxbcdt, cfg)

    # causal depthwise conv over (x, B, C) in x's dtype, summed in the
    # reference's order
    xbc = torch.cat([xin, b, c], dim=-1)                   # (B,S,conv_ch)
    w = p.conv_w.to(xbc.dtype)
    width = s_cfg.conv_width
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    conv = xp[:, 0:s] * w[0]
    for i in range(1, width):
        conv = conv + xp[:, i:i + s] * w[i]
    xbc = F.silu((conv + p.conv_b.to(conv.dtype)).to(F32)).to(x.dtype)
    xin, b, c = torch.split(xbc, [d_inner, s_cfg.state_dim,
                                  s_cfg.state_dim], dim=-1)

    dt = _softplus(dt.to(F32) + p.dt_bias)                 # (B,S,H)
    xh = xin.reshape(bsz, s, nh, s_cfg.head_dim)
    y = ssd(xh, dt, -torch.exp(p.a_log), b, c, chunk=s_cfg.chunk)
    y = y + p.d_skip[None, None, :, None] * xh.to(y.dtype)
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = _gated_norm(p, y, z)
    return torch.matmul(y, p.out_proj).to(x.dtype)


def init_mamba2_state(cfg: ModelConfig, batch: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero recurrent state: ``h`` (B, nh, N, P) and the conv window
    ``conv`` (B, W-1, conv_ch), both float32 whatever the compute
    dtype."""
    s, _, nh, conv_ch = _dims(cfg)
    return {"h": torch.zeros((batch, nh, s.state_dim, s.head_dim),
                             dtype=F32, device=device),
            "conv": torch.zeros((batch, s.conv_width - 1, conv_ch),
                                dtype=F32, device=device)}


def mamba2_decode(p: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                  h_state: torch.Tensor, conv_state: torch.Tensor
                  ) -> torch.Tensor:
    """One token. x: (B, 1, d_model); ``h_state`` (B, nh, N, P) and
    ``conv_state`` (B, W-1, conv_ch) are this layer's float32 state,
    updated in place.  Returns y (B, 1, d_model)."""
    s_cfg, d_inner, nh, _ = _dims(cfg)
    bsz = x.shape[0]
    zxbcdt = torch.matmul(x, p.in_proj)
    z, xin, b, c, dt = _split_in_proj(zxbcdt[:, 0], cfg)   # (B, ...)

    xbc = torch.cat([xin, b, c], dim=-1)                   # (B,conv_ch)
    hist = torch.cat([conv_state, xbc[:, None, :].to(F32)], dim=1)
    conv = torch.einsum("bwc,wc->bc", hist, p.conv_w) + p.conv_b
    xbc = F.silu(conv).to(x.dtype)
    conv_state.copy_(hist[:, 1:, :])
    xin, b, c = torch.split(xbc, [d_inner, s_cfg.state_dim,
                                  s_cfg.state_dim], dim=-1)

    dt = _softplus(dt.to(F32) + p.dt_bias[None, :])        # (B,H)
    a = torch.exp(dt * (-torch.exp(p.a_log))[None, :])
    xh = xin.reshape(bsz, nh, s_cfg.head_dim).to(F32)
    h = (h_state * a[..., None, None]
         + dt[..., None, None] * b.to(F32)[:, None, :, None]
         * xh[:, :, None, :])
    h_state.copy_(h)
    y = torch.einsum("bn,bhnp->bhp", c.to(F32), h)
    y = y + p.d_skip[None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = _gated_norm(p, y, z[:, None, :])
    return torch.matmul(y, p.out_proj).to(x.dtype)
