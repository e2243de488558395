"""Plain PyTorch versions of dense and paged decode attention (the
reference's ``kernels/decode_attention/ref.py`` oracles)."""

from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, kv_lengths, *, scale=None):
    """q: (B, H, D); k/v: (B, Hkv, S, D); kv_lengths: (B,).

    GQA is computed grouped (q viewed as (B, Hkv, G, D)); float32
    softmax over the positions ``< kv_lengths[b]``; a lane with no live
    key outputs 0.  The plain version of both K3 and K6a.
    """
    b, h, d = q.shape
    _, hkv, sk, _ = k.shape
    group = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    qg = q.reshape(b, hkv, group, d).float() * scale
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float())
    pos = torch.arange(sk, device=q.device)
    mask = pos[None, None, None, :] < kv_lengths[:, None, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    denom = torch.sum(p, dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bkgs,bksd->bkgd", p / denom, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """pages: (P, Hkv, ps, D); block_tables: (B, T) physical page ids in
    logical order -> each lane's logical view (B, Hkv, T*ps, D)."""
    g = pages[block_tables.long()]                 # (B, T, Hkv, ps, D)
    b, t, hkv, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, t * ps, d)


def decode_attention_paged_ref(q, k_pages, v_pages, block_tables,
                               kv_lengths, *, scale=None):
    """q: (B, H, D); pools (P, Hkv, ps, D); block_tables (B, T)."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    return decode_attention_ref(q, k, v, kv_lengths, scale=scale)
