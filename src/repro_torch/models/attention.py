"""GQA attention with RoPE: prompt forward (flash, K2), dense decode step
(length-aware decode, K3) and paged decode step (block-table decode,
K1).  Port of the reference's ``models/attention.py`` dense paths."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_paged)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (ModelConfig, apply_rope, frozen,
                                       rope_angles)


class Attention(nn.Module):
    """wq (d, H*hd), wk/wv (d, Hkv*hd), wo (H*hd, d); QKV biases when the
    config has them.  Zero-filled: ``init_lm`` or ``convert`` fills it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.hd, cfg.compute_dtype

        def z(*shape):
            return frozen(torch.zeros(shape, dtype=dt, device=device))

        self.wq = z(d, cfg.n_heads * hd)
        self.wk = z(d, cfg.n_kv_heads * hd)
        self.wv = z(d, cfg.n_kv_heads * hd)
        self.wo = z(cfg.n_heads * hd, d)
        if cfg.qkv_bias:
            self.bq = z(cfg.n_heads * hd)
            self.bk = z(cfg.n_kv_heads * hd)
            self.bv = z(cfg.n_kv_heads * hd)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    hd = cfg.hd
    q = torch.matmul(x, p.wq)
    k = torch.matmul(x, p.wk)
    v = torch.matmul(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def attention_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                      return_kv: bool = False):
    """Causal full-sequence attention at positions 0..S-1. x: (B, S, d).
    With ``return_kv`` also returns (k, v) as (B, Hkv, S, D)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = flash_attention(qt, kt, vt, causal=True,
                          window=cfg.sliding_window)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    out = torch.matmul(out, p.wo)
    if return_kv:
        return out, (kt, vt)
    return out


def check_fp_kv(cfg: ModelConfig) -> None:
    """The port's caches hold the compute dtype; int8 KV is M6."""
    if cfg.kv_quant is not None:
        raise ValueError(f"{cfg.name}: kv_quant={cfg.kv_quant!r} is not "
                         "ported yet, it comes with M6 (int8 KV cache)")


def attention_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor):
    """Single-token decode against a dense per-lane cache.

    x: (B, 1, d); k_cache/v_cache: (B, Hkv, Smax, D), one layer's slice
    of the stacked cache; cache_len: (B,) int32.  The new token's K/V go
    to ring slot ``len mod Smax`` of each lane IN PLACE (the reference
    returns updated caches; the port saves the copy and returns the same
    tensors).  A full-context cache never wraps (the engine caps the
    length below Smax); a sliding-window cache rotates in it.
    """
    check_fp_kv(cfg)
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    cos, sin = rope_angles(cache_len[:, None], cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0].contiguous()
    k = apply_rope(k, cos, sin)[:, 0]
    v = v[:, 0]
    smax = k_cache.shape[2]
    slot = (cache_len % smax).long()
    lanes = torch.arange(b, device=x.device)
    k_cache[lanes, :, slot] = k.to(k_cache.dtype)
    v_cache[lanes, :, slot] = v.to(v_cache.dtype)
    eff_len = torch.clamp(cache_len + 1, max=smax).to(torch.int32)
    out = decode_attention(q, k_cache, v_cache, eff_len)
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return torch.matmul(out, p.wo), k_cache, v_cache


def attention_decode_paged(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           cache_len: torch.Tensor):
    """Single-token decode against a paged KV cache.

    x: (B, 1, d); k_pages/v_pages: (P, Hkv, ps, D), one layer's slice of
    the global pool; block_tables: (B, T) int32 page ids in logical
    order; cache_len: (B,) int32.  The new token's K/V are written at
    slot ``len mod T*ps`` of the lane's table IN PLACE (the reference
    returns updated pools; the port saves the copy and returns the same
    tensors).  Distinct live lanes own distinct pages, so the batched
    write never collides on a page a live lane reads.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    cos, sin = rope_angles(cache_len[:, None], cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0].contiguous()
    k = apply_rope(k, cos, sin)[:, 0]
    v = v[:, 0]
    ps = k_pages.shape[2]
    t = block_tables.shape[1]
    cap = t * ps                         # positions the table can back
    slot = cache_len % cap
    page = torch.gather(block_tables, 1,
                        (slot // ps)[:, None].long())[:, 0].long()
    off = (slot % ps).long()
    k_pages[page, :, off] = k.to(k_pages.dtype)
    v_pages[page, :, off] = v.to(v_pages.dtype)
    eff_len = torch.clamp(cache_len + 1, max=cap).to(torch.int32)
    out = decode_attention_paged(q, k_pages, v_pages, block_tables, eff_len)
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return torch.matmul(out, p.wo), k_pages, v_pages
