"""Blockwise (flash-style) attention in plain PyTorch: O(Sq x block)
memory, the reference's ``kernels/flash_attention/blockwise.py``.

A loop over key blocks with an online-softmax carry, as the reference's
``lax.scan``.  It is the dry run's attention on the meta device (K2's
``meta`` arm, :func:`~repro_torch.kernels.flash_attention.ops.
flash_attention`): the FLOP counter and the liveness of the meta pass
then see flash-shaped work, every intermediate bounded to (B, H, Sq,
block), and no (Sq x Sk) scores; there, the blocks share one shape, so
the first block is run under :func:`~repro_torch.core.op_analysis.
repeated` for all of them.  It is never the main path's attention.
GQA is computed grouped (no KV head replication is materialized).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.op_analysis import repeated

_NEG_INF = -1e30


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale=None, block: int = 512,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's
    dtype.  ``q_offset`` positions the query block globally (Sq < Sk)."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if h % hkv:
        raise ValueError(f"H {h} is not a multiple of Hkv {hkv}")
    group = h // hkv
    block = min(block, sk)
    if sk % block:
        raise ValueError(f"Sk {sk} is not a multiple of the block {block}")
    nblk = sk // block
    scale = float(scale if scale is not None else d ** -0.5)
    dev = q.device

    qg = q.reshape(b, hkv, group, sq, d).to(torch.float32) * scale
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, group, sq), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l_sum = torch.zeros((b, hkv, group, sq), dtype=torch.float32,
                        device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32,
                      device=dev)
    def step(j):
        nonlocal m, l_sum, acc
        kj = k[:, :, j * block:(j + 1) * block].to(torch.float32)
        vj = v[:, :, j * block:(j + 1) * block].to(torch.float32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj)
        k_pos = j * block + torch.arange(block, device=dev)
        mask = torch.ones((sq, block), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, torch.zeros_like(p))
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                    p, vj)
        m = m_new

    if q.device.type == "meta" and nblk > 1:
        # shapes only: every block has the same shapes and replaces the
        # carry, so one block counted nblk times stands for all
        with repeated(nblk):
            step(0)
    else:
        for j in range(nblk):
            step(j)
    l_sum = torch.where(l_sum == 0.0, torch.ones_like(l_sum), l_sum)
    out = (acc / l_sum[..., None]).reshape(b, h, sq, d)
    return out.to(q.dtype)
