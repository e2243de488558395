"""Plain PyTorch versions of the SSD (Mamba-2) scan.

* :func:`ssd_chunk_ref` -- the intra-chunk pass that K10 computes (the
  reference's ``ssd_chunk_pallas`` / ``ssd_intra_ref``);
* :func:`ssd_chunked` and :func:`ssd_naive` -- copies of the
  reference's ``models/ssm.py`` chunked dual form and step recurrence,
  kept as oracles as the reference's ``ref.py`` re-exports them.

Shapes: x (B,S,H,P); dt (B,S,H); ``a`` (H,) is the NEGATIVE decay rate
A (the reference names it ``a_log``; ``mamba2_forward`` passes
``-exp(a_log)``); b/c (B,S,N).  Everything is computed in float32.
The decay exponent ``cum_i - cum_j`` is masked to -inf above the
diagonal BEFORE ``exp``: it is positive there and may overflow, and
``inf * 0`` would be NaN.
"""

from __future__ import annotations

import torch

__all__ = ["inter_chunk_output", "inter_chunk_starts", "ssd_chunk_ref",
           "ssd_chunked", "ssd_from_intra", "ssd_naive"]

F32 = torch.float32


def _chunks(x, dt, a, b, c, q: int):
    """Reshape to chunks of ``q``: xc (B,NC,Q,H,P), dtc (B,NC,Q,H),
    bc/cc (B,NC,Q,N), cum (B,NC,H,Q) -- the within-chunk inclusive
    cumsum of ``dt * a``."""
    bsz, s, h, p = x.shape
    nc = s // q
    xc = x.reshape(bsz, nc, q, h, p).to(F32)
    dtc = dt.reshape(bsz, nc, q, h).to(F32)
    bc, cc, cum = _b_c_cum(dt, a, b, c, q)
    return xc, dtc, bc, cc, cum


def _b_c_cum(dt, a, b, c, q: int):
    """bc/cc (B,NC,Q,N) and cum (B,NC,H,Q) of :func:`_chunks`."""
    bsz, s, h = dt.shape
    n = b.shape[-1]
    nc = s // q
    dtc = dt.reshape(bsz, nc, q, h).to(F32)
    bc = b.reshape(bsz, nc, q, n).to(F32)
    cc = c.reshape(bsz, nc, q, n).to(F32)
    la = (dtc * a.to(F32)[None, None, None, :]).permute(0, 1, 3, 2)
    return bc, cc, torch.cumsum(la, dim=-1)


def _intra(xc, dtc, bc, cc, cum):
    """(y_intra (B,NC,Q,H,P), states (B,NC,H,N,P), chunk_decay
    (B,NC,H)) of one chunked input."""
    q = cum.shape[-1]
    seg = cum[..., :, None] - cum[..., None, :]                # (B,NC,H,Q,Q)
    mask = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    l_mat = torch.exp(seg.masked_fill(~mask, float("-inf")))
    cb = torch.einsum("bzqn,bzkn->bzqk", cc, bc)               # (B,NC,Q,Q)
    w = cb[:, :, None] * l_mat                                 # (B,NC,H,Q,Q)
    xdt = xc * dtc[..., None]                                  # (B,NC,Q,H,P)
    y = torch.einsum("bzhqk,bzkhp->bzqhp", w, xdt)
    decay_to_end = torch.exp(cum[..., -1:] - cum)              # (B,NC,H,Q)
    bw = bc[:, :, None] * decay_to_end[..., None]              # (B,NC,H,Q,N)
    states = torch.einsum("bzhqn,bzqhp->bzhnp", bw, xdt)
    return y, states, torch.exp(cum[..., -1])


def ssd_chunk_ref(x, dt, a, b, c, chunk: int):
    """Intra-chunk SSD pass, the function of K10.  With ``Q = min(chunk,
    S)`` (S must be a multiple of Q) and ``cum`` the inclusive cumsum
    of ``dt * a`` over each chunk:

    * ``y_intra[i] = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j``
      (B,S,H,P);
    * ``states = sum_j exp(cum_{Q-1} - cum_j) B_j (dt_j x_j)^T``
      (B,NC,H,N,P);
    * ``chunk_decay = exp(cum_{Q-1})`` (B,NC,H);

    all float32."""
    bsz, s, h, p = x.shape
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    y, states, decay = _intra(*_chunks(x, dt, a, b, c, q))
    return y.reshape(bsz, s, h, p), states, decay


def ssd_naive(x, dt, a, b, c):
    """Reference recurrence, one step per position: (B,S,H,P) float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    decay = torch.exp(dt * a[None, None, :])                   # (B,S,H)
    xf, dtf, bf, cf = (t.to(F32) for t in (x, dt, b, c))
    hstate = torch.zeros((bsz, h, n, p), dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        hstate = (hstate * decay[:, t].to(F32)[..., None, None]
                  + dtf[:, t, :, None, None] * bf[:, t, None, :, None]
                  * xf[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], hstate))
    return torch.stack(ys, dim=1)


def ssd_chunked(x, dt, a, b, c, chunk: int = 256):
    """Chunked SSD (the dual form), same signature as :func:`ssd_naive`,
    returning ``x.dtype``.  A length that is not a multiple of the chunk
    is zero-padded: padded steps carry dt = 0, so decay 1 and no input,
    and the recurrence is unchanged."""
    return ssd_from_intra(ssd_chunk_ref, x, dt, a, b, c, chunk)


def ssd_from_intra(intra, x, dt, a, b, c, chunk: int):
    """The full SSD with ``intra(x, dt, a, b, c, chunk=q)`` as its
    intra-chunk pass (:func:`ssd_chunk_ref` here, the kernel in
    ``ops.ssd``): zero-pads S to a multiple of ``q = min(chunk, S)``,
    adds the inter-chunk recurrence's output, crops and casts to
    ``x.dtype``."""
    bsz, s0, h, p = x.shape
    q = min(chunk, s0)
    pad = (-s0) % q
    dt, a = dt.to(F32), a.to(F32)
    if pad:
        x, dt, b, c = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, b, c))
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    s = s0 + pad
    y_intra, states, chunk_decay = intra(x, dt, a, b, c, chunk=q)
    _, cc, cum = _b_c_cum(dt, a, b, c, q)
    h_starts = inter_chunk_starts(states, chunk_decay)
    y_inter = inter_chunk_output(cum, cc, h_starts).reshape(bsz, s, h, p)
    return (y_intra + y_inter)[:, :s0].to(x.dtype)


def inter_chunk_starts(states, chunk_decay):
    """The state entering each chunk: ``h_0 = 0``, ``h_{z+1} = h_z *
    chunk_decay_z + states_z``.  Returns (B,NC,H,N,P) float32."""
    hstate = torch.zeros_like(states[:, 0])
    starts = []
    for z in range(states.shape[1]):
        starts.append(hstate)
        hstate = hstate * chunk_decay[:, z, :, None, None] + states[:, z]
    return torch.stack(starts, dim=1)


def inter_chunk_output(cum, cc, h_starts):
    """``y_inter[i] = exp(cum_i) C_i . h_start`` per chunk: cum (B,NC,H,Q),
    cc (B,NC,Q,N), h_starts (B,NC,H,N,P) -> (B,NC,Q,H,P)."""
    y = torch.matmul(cc[:, :, None], h_starts)                 # (B,NC,H,Q,P)
    return (torch.exp(cum)[..., None] * y).permute(0, 1, 3, 2, 4)
