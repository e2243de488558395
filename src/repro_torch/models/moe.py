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

On a mesh of more than one rank (:mod:`repro_torch.parallel.sharding`)
the experts are split over the axes their weights are stored over
(``sharding.expert_axes``: ``model``), and in serve mode each expert's
d_ff over ``data`` as well.  The tokens stay whole over those axes, so
no all-to-all moves them: each rank routes every token it holds (the
router read whole), computes the slots of its own experts only, combines
the assignments to them, and the partial outputs are summed over the
split axes (``reduce_out``).  In train mode the rows are split over the
batch axes; the capacity is then the unsharded call's, from every batch
rank's tokens, and an assignment is kept by its slot in the unsharded
call: its position among this rank's assignments to its expert plus the
lower batch ranks' count for that expert (one gather of the ``(E,)``
counts).  The aux loss is this rank's share (its tokens' terms over
every rank's count, ``ce`` gathered), so the shares sum over the batch
axes to the unsharded loss.  The gates and the dispatch's input pass
``copy_in``: each rank's gradient of them covers its experts' terms, and
the sum over the split axes is the unsharded gradient; the aux path,
the same on every rank, is counted once.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.common import MoEConfig, frozen
from repro_torch.models.mlp import SwiGLU, swiglu
from repro_torch.parallel import sharding

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
    routes every token at once.  On a mesh whose batch axes split the
    rows (``sharding.split_batch``) the token count is the unsharded
    call's, every batch rank's rows in rank order: a chunk lies on one
    rank or spans whole ranks, and ``aux`` is this rank's share."""
    b, s, d = x.shape
    t = b * s
    rows = sharding.batch_split_axes()
    n_rows = sharding.extent(rows)
    t_all = t * n_rows
    if not (chunk and t_all > chunk and t_all % chunk == 0):
        return _moe_tokens(p, x, moe, rows, n_rows)
    if t % chunk == 0:           # whole chunks on this rank
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        for xi in x.reshape(t // chunk, 1, chunk, d):
            out, a = _moe_tokens(p, xi, moe, rows, 1)
            aux = aux + a
            outs.append(out)
        return torch.stack(outs).reshape(b, s, d), aux * (chunk / float(t_all))
    if chunk % t:
        raise ValueError(f"a dispatch chunk of {chunk} tokens neither "
                         f"divides nor is a multiple of this rank's {t} "
                         f"(rows split over {rows})")
    out, aux = _moe_tokens(p, x, moe, rows, chunk // t)
    return out, aux * (chunk / float(t_all))


def _moe_tokens(p: MoE, x: torch.Tensor, moe: MoEConfig, rows=(),
                span: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One routing call over this rank's tokens ``x`` and those of the
    other ranks of its group: ``span`` consecutive ranks along ``rows``
    (1: this rank's tokens alone), whose tokens in rank order are the
    unsharded call's."""
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    n_e, k = moe.n_experts, moe.top_k
    t_all = t * span
    cap = capacity(t_all, moe)
    # this rank's experts (and, in serve mode, its block of their d_ff):
    # its partial outputs sum over both
    e0, e1 = sharding.block_of(n_e, sharding.expert_axes(p.w_gate))
    part = sharding.expert_axes(p.w_gate) + sharding.axes_of(p.w_gate, 2)

    logits = torch.matmul(xf.float(),
                          sharding.weight(p.router, None, None).float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (t, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # load-balance + z losses (Switch Transformer); the one-hot is a
    # comparison, so no kernel reads the ids back to size it
    experts = torch.arange(n_e, device=dev)
    top1 = expert_ids[:, :1] == experts
    me = torch.mean(probs, dim=0)
    ce = torch.mean(top1.float(), dim=0)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

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
    slot = pos
    if span > 1:
        # the group's counts: an assignment's slot in the unsharded call
        # adds the lower ranks' assignments to its expert, ``ce`` is
        # every rank's top-1 picks, and this rank's means become its
        # share of the group's
        counts = torch.stack([
            torch.searchsorted(se, experts, side="right") - seg_start,
            torch.sum(top1, dim=0)])
        every = sharding.relayout(counts[None], 0, rows, None)  # (R, 2, E)
        i = sharding.block_of(sharding.extent(rows), rows)[0]
        g0 = i - i % span
        slot = pos + torch.sum(every[g0:i, 0], dim=0)[se]
        ce = torch.sum(every[g0:g0 + span, 1], dim=0).float() / t_all
        me, z = me / span, z / span
    aux = moe.router_aux_weight * n_e * torch.sum(me * ce)
    aux = aux + 1e-4 * z

    keep = slot < cap
    n_l = e1 - e0
    local = se
    if n_l < n_e:            # the other experts are other ranks'
        keep = keep & (se >= e0) & (se < e1)
        local = se - e0
    e_idx = torch.where(keep, local, n_l - 1)
    c_idx = torch.where(keep, pos, cap)                  # cap: the dump slot
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    buf = torch.zeros((n_l, cap + 1, d), dtype=x.dtype, device=dev)
    # xf[st] as a permutation of each token's k copies: the backward
    # sums a token's k cotangents in a fixed order (expand's reduction),
    # where the gather's backward would accumulate them atomically
    xk = sharding.copy_in(xf, part)[:, None, :].expand(t, k, d).reshape(n, d)
    buf[e_idx, c_idx] = torch.where(keep[:, None], xk[order], zero)
    ebuf = buf[:, :cap]                                      # (E_l, C, d)

    g = torch.bmm(ebuf, sharding.weight(p.w_gate, ..., None, ...))
    u = torch.bmm(ebuf, sharding.weight(p.w_up, ..., None, ...))
    h = F.silu(g.float()).to(x.dtype) * u
    eout = torch.bmm(h, sharding.weight(p.w_down, ..., ..., None))

    # combine: a dropped (or another rank's) assignment reads a clamped
    # slot (as the reference's gather does out of bounds) and is zeroed,
    # so in the backward every slot takes at most one nonzero cotangent
    gathered = torch.where(keep[:, None],
                           eout[e_idx, torch.clamp(c_idx, max=cap - 1)],
                           zero)
    contrib = gathered * sharding.copy_in(sg, part)[:, None].to(x.dtype)
    # each token's k terms in sorted order (ascending expert id), summed
    # left to right as the reference's scatter-add applies them
    by_token = contrib[torch.argsort(st, stable=True)].reshape(t, k, d)
    out = by_token[:, 0]
    for j in range(1, k):
        out = out + by_token[:, j]
    out = sharding.reduce_out(out, part)

    if moe.n_shared_experts:
        out = out + swiglu(p.shared, xf)
    return out.reshape(b, s, d), aux
