"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

Port of the reference's ``models/whisper.py``: precomputed frame
embeddings (B, S_enc, d) go through pre-LN encoder blocks with
bidirectional self-attention (K2 unmasked) and GELU MLPs; the decoder
blocks add causal self-attention (K2 causal), cross-attention into the
encoder states (K2 unmasked at S_dec != S_enc) and a GELU MLP.  RoPE
takes the place of learned absolute positions, as in the reference;
cross-attention has none.

Cached decode keeps the decoder's self-attention K/V in a dense per-lane
cache ``k``/``v`` (L, B, Hkv, max_len, D) and each layer's
cross-attention K/V, computed once from the encoder states, in
``cross_k``/``cross_v`` (L, B, Hkv, S_enc, D); a step runs K3 over both
(the cross read at every lane's full S_enc).  The cache stays dense and
in the compute dtype: the reference refuses int8 KV here, and so does
the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (Attention, attention_decode,
                                          attention_forward, project_q)
from repro_torch.models.common import (Embedding, ModelConfig, apply_norm,
                                       dense_init, embed, lm_logits,
                                       make_norm)
from repro_torch.models.mlp import GeluMLP, gelu_mlp
from repro_torch.models.transformer import NORMS

Cache = Dict[str, torch.Tensor]


def check_encdec(cfg: ModelConfig) -> None:
    """An encoder-decoder config the port has: encoder layers, no
    experts, no recurrent state, no window, one of the three norms."""
    if not cfg.is_encdec or cfg.moe is not None or cfg.ssm is not None \
            or cfg.sliding_window is not None or cfg.norm not in NORMS:
        raise ValueError(f"{cfg.name}: not an encoder-decoder the port has "
                         f"(family {cfg.family!r}, {cfg.n_encoder_layers} "
                         f"encoder layers, norm {cfg.norm!r})")


class EncoderBlock(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``mlp`` (GELU)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = make_norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.norm2 = make_norm(cfg, device)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, cfg.compute_dtype, device)


class DecoderBlock(nn.Module):
    """``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``,
    ``mlp`` (GELU)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = make_norm(cfg, device)
        self.self_attn = Attention(cfg, device)
        self.norm_x = make_norm(cfg, device)
        self.cross_attn = Attention(cfg, device)
        self.norm2 = make_norm(cfg, device)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, cfg.compute_dtype, device)


class Whisper(nn.Module):
    """The reference's ``init_whisper`` tree, one module per layer:
    ``embed``, ``encoder``, ``decoder``, ``enc_final_norm``,
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_encdec(cfg)
        self.embed = Embedding(cfg, device)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, device)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(DecoderBlock(cfg, device)
                                     for _ in range(cfg.n_layers))
        self.enc_final_norm = make_norm(cfg, device)
        self.final_norm = make_norm(cfg, device)


@torch.no_grad()
def init_whisper(cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device) -> Whisper:
    """Random weights with the reference's scheme (fan-in truncated
    normal matrices, 0.02 embedding, zero biases, unit norms), drawn in
    float32 on ``device`` from ``generator``, stored in the compute
    dtype.  The values differ from ``jax.random``'s for the same seed."""
    model = Whisper(cfg, device)
    for name, w in model.named_parameters():
        if w.dim() == 2:                           # biases, norms: as made
            scale = 0.02 if name == "embed.tok" else None
            w.copy_(dense_init(tuple(w.shape), generator, device,
                               scale=scale).to(w.dtype))
    return model


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

@torch.no_grad()
def encode(params: Whisper, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> encoder states (B,
    S_enc, d) in the compute dtype."""
    x = frames.to(cfg.compute_dtype)
    for blk in params.encoder:
        h = apply_norm(blk.norm1, x)
        x = x + attention_forward(blk.attn, h, cfg, causal=False)
        x = x + gelu_mlp(blk.mlp, apply_norm(blk.norm2, x))
    return apply_norm(params.enc_final_norm, x)


def enc_kv(p: Attention, enc: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cross-attention's K/V of the encoder states: (B, Hkv, S_enc, D)
    each, contiguous (the reference's ``_enc_kv``)."""
    b, s, _ = enc.shape
    k = torch.matmul(enc, p.wk)
    v = torch.matmul(enc, p.wv)
    if cfg.qkv_bias:
        k = k + p.bk
        v = v + p.bv
    return (k.reshape(b, s, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
            .contiguous(),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
            .contiguous())


def cross_attention(p: Attention, x: torch.Tensor, kv, cfg: ModelConfig
                    ) -> torch.Tensor:
    """Unmasked attention of the decoder stream x (B, S, d) into the
    encoder's K/V (``enc_kv``): K2 at Sq = S, Sk = S_enc."""
    b, s, _ = x.shape
    q = project_q(p, x, cfg).transpose(1, 2).contiguous()
    out = flash_attention(q, kv[0], kv[1], causal=False)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return torch.matmul(out, p.wo)


@torch.no_grad()
def decode_forward(params: Whisper, tokens: torch.Tensor, enc: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder pass: tokens (B, S_dec) over the encoder
    states ``enc`` -> logits (B, S_dec, V) float32."""
    x = embed(params.embed, tokens)
    for blk in params.decoder:
        h = apply_norm(blk.norm1, x)
        x = x + attention_forward(blk.self_attn, h, cfg, causal=True)
        hx = apply_norm(blk.norm_x, x)
        x = x + cross_attention(blk.cross_attn, hx,
                                enc_kv(blk.cross_attn, enc, cfg), cfg)
        x = x + gelu_mlp(blk.mlp, apply_norm(blk.norm2, x))
    x = apply_norm(params.final_norm, x)
    return lm_logits(params.embed, x, cfg)


# ----------------------------------------------------------------------
# cached decode
# ----------------------------------------------------------------------

@torch.no_grad()
def init_whisper_cache(params: Whisper, enc: torch.Tensor, cfg: ModelConfig,
                       batch: int, max_len: int) -> Cache:
    """``len`` (B,) int32 at 0, the self-attention cache ``k``/``v`` (L,
    B, Hkv, max_len, D) zeroed, and every layer's cross-attention K/V of
    ``enc`` in ``cross_k``/``cross_v`` (L, B, Hkv, S_enc, D)."""
    dev = enc.device
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    cross = [enc_kv(blk.cross_attn, enc, cfg) for blk in params.decoder]
    return {
        "len": torch.zeros(batch, dtype=torch.int32, device=dev),
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "cross_k": torch.stack([k for k, _ in cross]),
        "cross_v": torch.stack([v for _, v in cross]),
    }


@torch.no_grad()
def whisper_decode_step(params: Whisper, cfg: ModelConfig, cache: Cache,
                        tokens: torch.Tensor
                        ) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,) -> (logits (B, V) float32, cache): each layer writes
    its new self-attention K/V in place and reads the cross K/V at every
    lane's full encoder length; the returned cache holds the same
    tensors and ``len + 1``."""
    if cfg.kv_quant is not None:
        raise NotImplementedError(
            "int8 KV cache is wired for the decoder-only families; "
            "whisper-base caches are small enough in bf16")
    x = embed(params.embed, tokens[:, None])
    cache_len = cache["len"]
    b = tokens.shape[0]
    enc_len = torch.full((b,), cache["cross_k"].shape[3], dtype=torch.int32,
                         device=tokens.device)
    for i, blk in enumerate(params.decoder):
        h = apply_norm(blk.norm1, x)
        x = x + attention_decode(blk.self_attn, h, cfg, cache["k"][i],
                                 cache["v"][i], cache_len)[0]
        hx = apply_norm(blk.norm_x, x)
        q = project_q(blk.cross_attn, hx, cfg)[:, 0].contiguous()
        co = decode_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                              enc_len)
        x = x + torch.matmul(co.reshape(b, 1, cfg.n_heads * cfg.hd),
                             blk.cross_attn.wo)
        x = x + gelu_mlp(blk.mlp, apply_norm(blk.norm2, x))
    x = apply_norm(params.final_norm, x)
    logits = lm_logits(params.embed, x[:, 0], cfg)
    new_cache = dict(cache)
    new_cache["len"] = cache_len + 1
    return logits, new_cache
