"""Collectives over mesh axes, and the autograd rules of the sharded
model.

A spec entry names the mesh axes one tensor dim is split over (``None``,
a name, or a tuple of names in mesh order); rank ``i`` along them holds
the ``i``-th of equal contiguous blocks (row-major over the axes, as
``PartitionSpec`` lays a dim out).  :func:`relayout` moves one dim from
one entry to another: a finer entry takes a sub-block, a coarser one
gathers, any other gathers the dim whole and takes the new block.

The sharded model keeps one convention for gradients: a tensor that is
whole on the ranks of an axis holds, on each, the gradient of the loss
that rank computes.  Along the axes the batch is split over, those are
partial (each rank's rows), so a weight's gradient sums over them; along
any other axis every rank computes the same loss, so its gradient is
whole and a block of it is just taken.  :class:`Gather` (a stored weight
to the layout a product reads), :class:`CopyIn` and :class:`ReduceOut`
(Megatron's ``f`` and ``g`` around a column- then row-parallel pair)
carry it.

A process group whose backend is gloo moves a CUDA tensor through the
host: NCCL refuses two ranks on one card, and this is how several ranks
share one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["CopyIn", "Gather", "ReduceOut", "all_gather", "all_reduce",
           "block", "local_of", "reduce_scatter", "relayout", "take"]


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """A new tensor: ``t`` summed (or maxed, ``op="max"``) over the ranks
    along ``axes``; ``t`` itself when the axes hold one rank."""
    axes = mesh.axes(axes)
    if not axes:
        return t
    group = mesh.get_group(axes)
    staged = _staged(t, group)
    buf = t.detach().to("cpu", copy=True) if staged else \
        t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if staged else buf


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axes`` concatenated on ``dim`` in
    row-major order; ``t`` itself when the axes hold one rank."""
    axes = mesh.axes(axes)
    if not axes:
        return t
    group = mesh.get_group(axes)
    staged = _staged(t, group)
    src = t.detach().contiguous()
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.extent(axes))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if staged else out


def reduce_scatter(t: torch.Tensor, mesh, axes, dim: int
                   ) -> torch.Tensor:
    """This rank's block along ``dim`` (over ``axes``) of ``t`` summed
    over the ranks along ``axes``; ``t`` itself when the axes hold one
    rank."""
    axes = mesh.axes(axes)
    if not axes:
        return t
    group = mesh.get_group(axes)
    staged = _staged(t, group)
    start, stop = block(mesh, t.shape[dim], axes)
    src = t.detach().cpu() if staged else t.detach()
    parts = [c.contiguous() for c in torch.split(src, stop - start, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(t.device) if staged else out


def block(mesh, n: int, axes) -> Tuple[int, int]:
    """This rank's ``[start, stop)`` of a dim of ``n`` split over
    ``axes``; raises when they do not divide it."""
    k = mesh.extent(axes)
    if n % k:
        raise ValueError(f"a dim of {n} does not split over {axes} "
                         f"({k} ranks)")
    size = n // k
    i = mesh.index(axes)
    return i * size, (i + 1) * size


def take(t: torch.Tensor, mesh, dim: int, axes) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor whole on that dim."""
    start, stop = block(mesh, t.shape[dim], axes)
    return t.narrow(dim, start, stop - start)


def local_of(t: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of a whole tensor under ``spec`` (contiguous, a
    copy when any dim is split)."""
    out = t
    for dim, axes in enumerate(spec):
        out = take(out, mesh, dim, axes)
    return out.contiguous() if out is not t else t


def relayout(t: torch.Tensor, mesh, dim: int, src, dst) -> torch.Tensor:
    """``t``, split over ``src`` on ``dim``, split over ``dst`` instead
    (no autograd)."""
    src, dst = mesh.axes(src), mesh.axes(dst)
    if src == dst:
        return t
    if dst[:len(src)] == src:              # finer: a sub-block of ours
        return take(t, mesh, dim, dst[len(src):])
    if src[:len(dst)] == dst:              # coarser: gather the rest
        return all_gather(t, mesh, src[len(dst):], dim)
    return take(all_gather(t, mesh, src, dim), mesh, dim, dst)


def _sub_block(g: torch.Tensor, mesh, dim: int, have, want
               ) -> torch.Tensor:
    """The ``want`` block of ``g``, which is this rank's ``have`` block;
    the first must lie inside the second."""
    n = g.shape[dim] * mesh.extent(have)
    h0, h1 = block(mesh, n, have)
    w0, w1 = block(mesh, n, want)
    if w0 < h0 or w1 > h1:
        raise ValueError(f"dim {dim}: the block over {want} is not inside "
                         f"the block over {have}")
    return g.narrow(dim, w0 - h0, w1 - w0)


class Gather(torch.autograd.Function):
    """A stored weight block (``src`` spec) to the block a product reads
    (``dst`` spec).  Backward: the gradient summed over the batch axes
    ``sum_axes``, then this rank's stored block of it -- a reduce-scatter
    where the stored block splits the read one further over batch axes
    (FSDP's gather over ``data``), an all-reduce over the rest."""

    @staticmethod
    def forward(ctx, w, mesh, src, dst, sum_axes):
        ctx.mesh, ctx.src, ctx.dst, ctx.sum_axes = mesh, src, dst, sum_axes
        out = w
        for dim, (s, d) in enumerate(zip(src, dst)):
            out = relayout(out, mesh, dim, s, d)
        return out.view_as(out) if out is w else out

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        pending = set(mesh.axes(ctx.sum_axes))
        takes = []
        for dim, (s, d) in enumerate(zip(ctx.src, ctx.dst)):
            have, want = mesh.axes(d), mesh.axes(s)
            finer = want[len(have):]
            if want[:len(have)] == have and finer and set(finer) <= pending:
                g = reduce_scatter(g, mesh, finer, dim)
                pending -= set(finer)
            else:
                takes.append((dim, d, s))
        g = all_reduce(g, mesh, tuple(pending))
        for dim, d, s in takes:
            g = _sub_block(g, mesh, dim, d, s)
        return g.contiguous(), None, None, None, None


class CopyIn(torch.autograd.Function):
    """Identity; backward sums the gradient over ``axes`` (the input of
    a column-parallel product, whole on every rank of the axes)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class ReduceOut(torch.autograd.Function):
    """Sum over ``axes`` (the partial outputs of a row-parallel
    product); backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_full(t: torch.Tensor, mesh, spec: Optional[Sequence]
                ) -> torch.Tensor:
    """The whole tensor of this rank's block ``t`` under ``spec`` (every
    rank of the mesh takes part); ``t`` when ``spec`` splits nothing."""
    if spec is None:
        return t
    out = t
    for dim, axes in enumerate(spec):
        out = all_gather(out, mesh, axes, dim)
    return out
