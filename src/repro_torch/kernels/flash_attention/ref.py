"""Plain PyTorch version of flash attention (the reference's
``kernels/flash_attention/ref.py`` oracle: causal / GQA / window)."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  scale=None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's
    dtype.  float32 softmax; a row with no live key gives 0."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    denom = torch.sum(p, dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bhqk,bhkd->bhqd", p / denom, vv.float())
    return out.to(q.dtype)
