"""Mixture-of-Experts layer: top-k routing, sort-based capacity dispatch.

Port of the reference's ``models/moe.py`` (arctic-480b: 128 experts,
top-2, a dense residual FFN beside; moonshot-v1-16b-a3b: 64 experts,
top-6, two shared experts).  The (tokens x k) assignments are sorted by
expert id (stably) and scattered into an ``(E, C, d)`` buffer, so an
expert holds at most ``C`` tokens; an assignment past an expert's
capacity is dropped.  The three expert products are batched matmuls
over that buffer: every expert's weights are read once per call, as in
the reference (which computes them outside any Pallas kernel).

The dispatch makes no shape from data and never reads a value back to
the host (no ``.item()``, ``nonzero`` or boolean indexing), so a decode
step that routes through it can be captured in a CUDA graph.  Every
kept ``(expert, slot)`` is written once; only the dump slot past the
capacity takes duplicates, and it is never read.  The combine adds a
token's k expert outputs in the order the reference's scatter-add
applies them (the sorted assignment order, i.e. ascending expert id),
with no atomics, so a call repeats its bits on the card; so does its
backward (a token's k cotangents are summed by a reduction, and every
read slot takes one).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.common import MoEConfig, frozen
from repro_torch.models.mlp import SwiGLU, swiglu

#: tokens per dispatch chunk, the reference's ``REPRO_MOE_CHUNK``
#: default (the port takes it as an argument and reads no environment)
DEFAULT_CHUNK = 65536


class MoE(nn.Module):
    """``router`` (d, E) float32 (the reference reads it in float32),
    ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d) in the compute
    dtype, and ``shared`` (a SwiGLU of ``f * n_shared_experts``) when
    the config has shared experts: the reference's ``init_moe`` leaves."""

    def __init__(self, d_model: int, moe: MoEConfig, dtype, device=None):
        super().__init__()
        e, f = moe.n_experts, moe.d_expert_ff

        def z(*shape, dt=dtype):
            return frozen(torch.zeros(shape, dtype=dt, device=device))

        self.router = z(d_model, e, dt=torch.float32)
        self.w_gate = z(e, d_model, f)
        self.w_up = z(e, d_model, f)
        self.w_down = z(e, f, d_model)
        if moe.n_shared_experts:
            self.shared = SwiGLU(d_model, f * moe.n_shared_experts, dtype,
                                 device)


def capacity(n_tokens: int, moe: MoEConfig) -> int:
    """Slots an expert holds for ``n_tokens`` routed tokens, 8-aligned
    (the reference's ``_capacity``)."""
    c = int(moe.capacity_factor * n_tokens * moe.top_k / moe.n_experts)
    return max(8, (c + 7) // 8 * 8)


def moe_forward(p: MoE, x: torch.Tensor, moe: MoEConfig,
                chunk: int = DEFAULT_CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss () float32).

    More than ``chunk`` tokens, when ``chunk`` divides them, are routed
    ``chunk`` at a time (each chunk with its own capacity) and the aux
    losses averaged, as the reference's scan over chunks; ``chunk=0``
    routes every token at once."""
    b, s, d = x.shape
    t = b * s
    if chunk and t > chunk and t % chunk == 0:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        for xi in x.reshape(t // chunk, 1, chunk, d):
            out, a = _moe_tokens(p, xi, moe)
            aux = aux + a
            outs.append(out)
        return torch.stack(outs).reshape(b, s, d), aux * (chunk / float(t))
    return _moe_tokens(p, x, moe)


def _moe_tokens(p: MoE, x: torch.Tensor, moe: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    n_e, k, cap = moe.n_experts, moe.top_k, capacity(t, moe)

    logits = torch.matmul(xf.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (t, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # load-balance + z losses (Switch Transformer); the one-hot is a
    # comparison, so no kernel reads the ids back to size it
    experts = torch.arange(n_e, device=dev)
    me = torch.mean(probs, dim=0)
    ce = torch.mean((expert_ids[:, :1] == experts).float(), dim=0)
    aux = moe.router_aux_weight * n_e * torch.sum(me * ce)
    aux = aux + 1e-4 * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # sort-based dispatch with capacity
    n = t * k
    flat_expert = expert_ids.reshape(-1)
    flat_gate = gate_vals.reshape(-1)
    flat_token = torch.arange(n, device=dev) // k
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    # position within its expert: rank - the expert's first rank
    seg_start = torch.searchsorted(se, experts, side="left")
    pos = torch.arange(n, device=dev) - seg_start[se]
    keep = pos < cap
    e_idx = torch.where(keep, se, n_e - 1)
    c_idx = torch.where(keep, pos, cap)                  # cap: the dump slot
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    buf = torch.zeros((n_e, cap + 1, d), dtype=x.dtype, device=dev)
    # xf[st] as a permutation of each token's k copies: the backward
    # sums a token's k cotangents in a fixed order (expand's reduction),
    # where the gather's backward would accumulate them atomically
    xk = xf[:, None, :].expand(t, k, d).reshape(n, d)
    buf[e_idx, c_idx] = torch.where(keep[:, None], xk[order], zero)
    ebuf = buf[:, :cap]                                        # (E, C, d)

    g = torch.bmm(ebuf, p.w_gate)
    u = torch.bmm(ebuf, p.w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    eout = torch.bmm(h, p.w_down)                              # (E, C, d)

    # combine: a dropped assignment reads a clamped slot (as the
    # reference's gather does out of bounds) and is zeroed, so in the
    # backward every slot takes at most one nonzero cotangent
    gathered = torch.where(keep[:, None],
                           eout[e_idx, torch.clamp(c_idx, max=cap - 1)],
                           zero)
    contrib = gathered * sg[:, None].to(x.dtype)
    # each token's k terms in sorted order (ascending expert id), summed
    # left to right as the reference's scatter-add applies them
    by_token = contrib[torch.argsort(st, stable=True)].reshape(t, k, d)
    out = by_token[:, 0]
    for j in range(1, k):
        out = out + by_token[:, j]

    if moe.n_shared_experts:
        out = out + swiglu(p.shared, xf)
    return out.reshape(b, s, d), aux
