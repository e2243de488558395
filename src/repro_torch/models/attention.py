"""GQA attention with RoPE: prompt forward (flash, K2), dense decode step
(length-aware decode, K3; K5 over an int8 cache) and paged decode step
(block-table decode, K1; K4 over int8 pools).  Port of the reference's
``models/attention.py`` dense paths."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_paged, decode_attention_paged_q8,
    decode_attention_q8)
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


def quantize_kv_token(k: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of KV vectors.
    k: (..., D) -> (int8 values, f32 scale (..., 1)).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    kf = k.float()
    scale = torch.amax(kf.abs(), dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """:func:`quantize_kv_token` of k and v in one pass (stacked), so a
    decode step pays its elementwise launches once."""
    vals, scales = quantize_kv_token(torch.stack([k, v]))
    return vals[0], vals[1], scales[0], scales[1]


def attention_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None):
    """Single-token decode against a dense per-lane cache.

    x: (B, 1, d); k_cache/v_cache: (B, Hkv, Smax, D), one layer's slice
    of the stacked cache; cache_len: (B,) int32.  The new token's K/V go
    to ring slot ``len mod Smax`` of each lane IN PLACE (the reference
    returns updated caches; the port saves the copy and returns the same
    tensors).  A full-context cache never wraps (the engine caps the
    length below Smax); a sliding-window cache rotates in it.

    With ``cfg.kv_quant == "int8"`` the caches are int8 with per-token
    f32 scales k_scale/v_scale (B, Hkv, Smax, 1): the new row and its
    scale are written at the slot, and K5 dequantizes in its read
    (``qblock=1``); the result also carries the scale tensors.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    cos, sin = rope_angles(cache_len[:, None], cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0].contiguous()
    k = apply_rope(k, cos, sin)[:, 0]
    v = v[:, 0]
    smax = k_cache.shape[2]
    slot = (cache_len % smax).long()
    lanes = torch.arange(b, device=x.device)
    eff_len = torch.clamp(cache_len + 1, max=smax).to(torch.int32)
    if cfg.kv_quant == "int8":
        kq, vq, ks, vs = _quantize_kv(k, v)
        k_cache[lanes, :, slot] = kq
        v_cache[lanes, :, slot] = vq
        k_scale[lanes, :, slot] = ks
        v_scale[lanes, :, slot] = vs
        out = decode_attention_q8(q, k_cache, k_scale, v_cache, v_scale,
                                  eff_len, qblock=1)
        caches = (k_cache, v_cache, k_scale, v_scale)
    else:
        k_cache[lanes, :, slot] = k.to(k_cache.dtype)
        v_cache[lanes, :, slot] = v.to(v_cache.dtype)
        out = decode_attention(q, k_cache, v_cache, eff_len)
        caches = (k_cache, v_cache)
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return (torch.matmul(out, p.wo),) + caches


def attention_decode_paged(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           cache_len: torch.Tensor,
                           k_scale_pages: Optional[torch.Tensor] = None,
                           v_scale_pages: Optional[torch.Tensor] = None):
    """Single-token decode against a paged KV cache.

    x: (B, 1, d); k_pages/v_pages: (P, Hkv, ps, D), one layer's slice of
    the global pool; block_tables: (B, T) int32 page ids in logical
    order; cache_len: (B,) int32.  The new token's K/V are written at
    slot ``len mod T*ps`` of the lane's table IN PLACE (the reference
    returns updated pools; the port saves the copy and returns the same
    tensors).  Distinct live lanes own distinct pages, so the batched
    write never collides on a page a live lane reads.

    With ``cfg.kv_quant == "int8"`` the pools are int8 with per-token
    f32 scale pools (P, Hkv, ps, 1), written at the same slot, and K4
    dequantizes in its read (``qblock=1``); the result also carries the
    scale pools.
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
    eff_len = torch.clamp(cache_len + 1, max=cap).to(torch.int32)
    if cfg.kv_quant == "int8":
        kq, vq, ks, vs = _quantize_kv(k, v)
        k_pages[page, :, off] = kq
        v_pages[page, :, off] = vq
        k_scale_pages[page, :, off] = ks
        v_scale_pages[page, :, off] = vs
        out = decode_attention_paged_q8(q, k_pages, k_scale_pages, v_pages,
                                        v_scale_pages, block_tables, eff_len,
                                        qblock=1)
        caches = (k_pages, v_pages, k_scale_pages, v_scale_pages)
    else:
        k_pages[page, :, off] = k.to(k_pages.dtype)
        v_pages[page, :, off] = v.to(v_pages.dtype)
        out = decode_attention_paged(q, k_pages, v_pages, block_tables,
                                     eff_len)
        caches = (k_pages, v_pages)
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return (torch.matmul(out, p.wo),) + caches
