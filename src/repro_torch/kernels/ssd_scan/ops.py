"""Wrappers for the SSD chunk scan: the intra-chunk kernel (K10) and the
full SSD built on it.

:func:`ssd_chunk`: a CPU tensor takes the plain version (``ref.py``); a
CUDA tensor launches ``csrc/ssd_scan.cu`` or raises -- there is no
fallback on the card.  The kernel takes every shape the wrapper admits
(Q 1 to 1024, N <= 128, P <= 64, x/b/c float32 or bfloat16): C.B^T once
per (b, chunk) into a workspace the wrapper allocates
(:func:`workspace_floats`), then the per-head products on the tensor
cores, split so that the float32 tolerance holds.  :func:`ssd` is the
port's ``ssd_pallas``: zero-pads S to a multiple of the chunk, runs
:func:`ssd_chunk`, then the inter-chunk recurrence and its output term
in plain PyTorch (about 0.1% of the operations, outside any kernel in
the reference too).

:class:`SSDChunkFn` (``ssd_chunk_fn``) is :func:`ssd_chunk` under
autograd: on the card its forward is exactly the kernel's launch, and
its backward recomputes the plain version in float32 from the saved
inputs and takes that recompute's vector-Jacobian product (the
reference differentiates its ``ssd_chunked`` with XLA's autodiff,
outside any Pallas kernel).  The kernel's outputs alone have no
``grad_fn``: a loss through :func:`ssd_chunk` would treat the
intra-chunk scan as a constant on the card.  :func:`ssd` runs the
Function exactly when autograd records.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        bind)
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref, ssd_from_intra

__all__ = ["ssd", "ssd_chunk", "ssd_chunk_fn", "SSDChunkFn",
           "ssd_chunk_backward", "workspace_floats", "COUNTER", "MAX_N",
           "MAX_P", "MAX_Q"]

COUNTER = LaunchCounter("ssd_chunk")
#: the widest state and head the kernel's tiles cover and the longest
#: chunk (csrc: MAX_N, MAX_P, MAX_Q); TILE its rows and keys per tile
MAX_N, MAX_P, MAX_Q, TILE = 128, 64, 1024, 64
#: the grid's chunk axis (B * S / Q) is a CUDA grid dimension
MAX_CHUNKS = 65535
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]


def workspace_floats(bsz: int, s: int, q: int) -> int:
    """Floats of C.B^T scratch one call needs: a ``QP x QP`` block per
    (b, chunk), ``QP`` the chunk rounded up to the kernel's 64-row tile
    (256 KB a chunk at Q 256)."""
    qp = -(-q // TILE) * TILE
    return bsz * (s // q) * qp * qp


def _check(x, dt, a, b, c, q):
    dev = x.device
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPE_CODE or b.dtype != x.dtype or \
            c.dtype != x.dtype:
        raise TypeError(f"x/b/c dtypes {x.dtype}/{b.dtype}/{c.dtype}: the "
                        "kernel takes one of float32/bfloat16 for all three")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("dt and a must be float32")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3:
        raise ValueError("want x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,N)")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) or \
            tuple(b.shape) != (bsz, s, n) or c.shape != b.shape:
        raise ValueError(f"shape mismatch x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} c {tuple(c.shape)}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and 1 <= q <= MAX_Q):
        raise ValueError(f"need P <= {MAX_P}, N <= {MAX_N} and chunk <= "
                         f"{MAX_Q} (P={p}, N={n}, chunk={q})")
    if bsz * (s // q) > MAX_CHUNKS:
        raise ValueError(f"{bsz * (s // q)} chunks: at most {MAX_CHUNKS}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_chunk(x, dt, a, b, c, *, chunk: int):
    """Intra-chunk SSD pass (K10): ``(y_intra (B,S,H,P), states
    (B,NC,H,N,P), chunk_decay (B,NC,H))``, all float32, for x (B,S,H,P),
    dt (B,S,H) float32, ``a`` (H,) float32 (negative), b/c (B,S,N); x,
    b and c in float32 or bfloat16.  ``Q = min(chunk, S)`` must divide
    S.  See :func:`ssd_chunk_ref` for the function."""
    bsz, s, h, p = x.shape
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, a, b, c, q)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, dt, a, b, c, q)
    n = b.shape[-1]
    nc = s // q
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((bsz, nc, h, n, p), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_floats(bsz, s, q), dtype=torch.float32,
                     device=x.device)
    fn = bind("ssd_scan", "ssd_chunk_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), states.data_ptr(),
                decay.data_ptr(), ws.data_ptr(), ws.numel(), bsz, s, h, p,
                n, q, _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise KernelLaunchError(f"ssd_chunk: CUDA error {rc}")
    COUNTER.n += 1
    return y, states, decay


def ssd_chunk_backward(x, dt, a, b, c, chunk: int, d_y, d_states,
                       d_decay):
    """Gradients (dx, ddt, da, db, dc) of :func:`ssd_chunk_ref` for the
    cotangents of its three outputs, each in its input's dtype: the
    plain version recomputed in float32 under autograd (its decay
    exponent masked to -inf above the diagonal before ``exp``, so that
    ``exp``'s backward there is 0, not ``inf * 0``) and differentiated.
    ``chunk_decay`` depends on dt and a only; y and the states on all
    five."""
    ins = [t.detach().requires_grad_() for t in (x, dt, a, b, c)]
    with torch.enable_grad():
        outs = ssd_chunk_ref(*ins, chunk)
    return torch.autograd.grad(outs, ins, (d_y, d_states, d_decay))


class SSDChunkFn(torch.autograd.Function):
    """K10 under autograd: the forward is :func:`ssd_chunk` (the
    kernel's launch on the card, counted as ever; the plain version on
    the CPU), the backward :func:`ssd_chunk_backward` from the saved
    inputs."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        return ssd_chunk(x, dt, a, b, c, chunk=chunk)

    @staticmethod
    def backward(ctx, d_y, d_states, d_decay):
        grads = ssd_chunk_backward(*ctx.saved_tensors, ctx.chunk, d_y,
                                   d_states, d_decay)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def ssd_chunk_fn(x, dt, a, b, c, *, chunk: int):
    """:func:`ssd_chunk` with gradients (:class:`SSDChunkFn`)."""
    return SSDChunkFn.apply(x, dt, a, b, c, chunk)


def ssd(x, dt, a, b, c, *, chunk: int):
    """Full SSD through K10, the reference's ``ssd_pallas`` with
    ``ssd_chunked``'s padding: x (B,S,H,P), dt (B,S,H), ``a`` (H,)
    negative, b/c (B,S,N) -> y (B,S,H,P) in x's dtype.  Any S: it is
    zero-padded to a multiple of ``Q = min(chunk, S)`` (padded steps
    get dt = 0: decay 1, no input) and cropped back; the inter-chunk
    recurrence is plain PyTorch, as in the reference.  When autograd
    records, the intra-chunk pass is :func:`ssd_chunk_fn`; its launch
    and bits are the same either way."""
    intra = ssd_chunk
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, b, c)):
        intra = ssd_chunk_fn
    return ssd_from_intra(intra, x, dt, a, b, c, chunk)
