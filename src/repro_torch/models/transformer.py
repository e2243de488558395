"""Dense decoder-only LM: prompt prefill, paged cache, decode step and the
multi-step decode dispatch.  Port of the reference's
``models/transformer.py`` for the dense family.

The reference stacks layers along a leading axis and runs them with
``lax.scan``; here each layer is its own module in a ``ModuleList`` and
a Python loop walks them.  The paged KV pool keeps the reference layout
``(L, P, Hkv, ps, D)`` and is updated in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.analysis.invariants import invariant
from repro_torch.models.attention import (Attention, attention_decode_paged,
                                          attention_forward)
from repro_torch.models.common import (Embedding, ModelConfig, RMSNorm,
                                       apply_norm, dense_init, embed,
                                       lm_logits)
from repro_torch.models.mlp import SwiGLU, swiglu

Cache = Dict[str, torch.Tensor]

#: the ROADMAP slice that brings temperature sampling (threefry parity)
RNG_SLICE = "M4 (sampling RNG parity: threefry fold_in/categorical)"


def check_dense(cfg: ModelConfig) -> None:
    """This slice serves the dense RMSNorm decoder only."""
    if cfg.family != "dense" or cfg.norm != "rmsnorm":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with norm "
                         f"{cfg.norm!r} is not ported yet (dense rmsnorm "
                         "decoders only)")


# ----------------------------------------------------------------------
# Modules + init
# ----------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.norm2 = RMSNorm(cfg.d_model, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, cfg.compute_dtype, device)


class LM(nn.Module):
    """Parameters of a dense decoder: ``embed``, ``blocks``,
    ``final_norm`` -- the reference's param tree, one module per layer."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_dense(cfg)
        self.embed = Embedding(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device)


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device: torch.device) -> LM:
    """Random weights with the reference's init scheme (fan-in truncated
    normal, 0.02 embedding, zero biases, unit norms), drawn in float32 on
    ``device`` from ``generator`` and stored in the compute dtype.  The
    values differ from ``jax.random``'s for the same seed."""
    lm = LM(cfg, device)
    dt = cfg.compute_dtype
    lm.embed.tok.copy_(dense_init(tuple(lm.embed.tok.shape), generator,
                                  device, scale=0.02).to(dt))
    if not cfg.tie_embeddings:
        lm.embed.head.copy_(dense_init(tuple(lm.embed.head.shape),
                                       generator, device).to(dt))
    for blk in lm.blocks:
        for mod in (blk.attn, blk.mlp):
            for w in mod.parameters():
                if w.dim() == 2:                 # matrices; biases stay 0
                    w.copy_(dense_init(tuple(w.shape), generator,
                                       device).to(dt))
    return lm


# ----------------------------------------------------------------------
# Prefill
# ----------------------------------------------------------------------

def block_forward(p: Block, x: torch.Tensor, cfg: ModelConfig):
    """Full-sequence block; returns (x, (k, v))."""
    h = apply_norm(p.norm1, x)
    att, kv = attention_forward(p.attn, h, cfg, return_kv=True)
    x = x + att
    h2 = apply_norm(p.norm2, x)
    return x + swiglu(p.mlp, h2), kv


@torch.no_grad()
def lm_prefill_batched(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
                       last_pos: Optional[torch.Tensor] = None):
    """Serving prefill: full-sequence pass returning the last-position
    logits and the KV cache ``(k, v)``, each (L, B, Hkv, S, D).

    ``last_pos`` (B,) selects which position's logits to return, so the
    engine can right-pad prompts to a shape bucket (causal attention
    keeps positions < last_pos untouched by the padding)."""
    x = embed(params.embed, tokens)
    ks, vs = [], []
    for blk in params.blocks:
        x, (k, v) = block_forward(blk, x, cfg)
        ks.append(k)
        vs.append(v)
    x = apply_norm(params.final_norm, x)
    if last_pos is None:
        x_last = x[:, -1]
    else:
        idx = last_pos.long().to(x.device)[:, None, None].expand(
            -1, 1, x.shape[-1])
        x_last = torch.gather(x, 1, idx)[:, 0]
    logits = lm_logits(params.embed, x_last, cfg)
    return logits, (torch.stack(ks), torch.stack(vs))


# ----------------------------------------------------------------------
# Paged KV cache + decode
# ----------------------------------------------------------------------

def paged_capacity(max_len: int, cfg: ModelConfig) -> int:
    """Positions one lane's block table must back: the window if the
    config slides, else the full context."""
    win = cfg.sliding_window
    return min(max_len, win) if win else max_len


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     page_size: int = 16, n_pages: Optional[int] = None,
                     device: torch.device) -> Cache:
    """Paged decode cache: ``k_pages``/``v_pages`` (L, P, Hkv, ps, D)
    shared by all lanes, ``block_tables`` (B, T) int32 page ids in
    logical order (T = capacity / ps, all page 0 until the caller maps
    pages), and ``len`` (B,) int32.  ``n_pages`` defaults to
    ``batch * T``."""
    s = paged_capacity(max_len, cfg)
    invariant(s % page_size == 0,
              f"page_size {page_size} must divide cache capacity {s}",
              page_size=page_size, capacity=s)
    bt_width = s // page_size
    if n_pages is None:
        n_pages = batch * bt_width
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.hd)
    return {
        "len": torch.zeros(batch, dtype=torch.int32, device=device),
        "block_tables": torch.zeros(batch, bt_width, dtype=torch.int32,
                                    device=device),
        "k_pages": torch.zeros(shape, dtype=cfg.compute_dtype,
                               device=device),
        "v_pages": torch.zeros(shape, dtype=cfg.compute_dtype,
                               device=device),
    }


def block_decode(p: Block, x: torch.Tensor, cfg: ModelConfig,
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_tables: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
    """One-token decode through one block. x: (B, 1, d)."""
    h = apply_norm(p.norm1, x)
    att, _, _ = attention_decode_paged(p.attn, h, cfg, k_pages, v_pages,
                                       block_tables, cache_len)
    x = x + att
    h2 = apply_norm(p.norm2, x)
    return x + swiglu(p.mlp, h2)


@torch.no_grad()
def lm_decode_step(params: LM, cfg: ModelConfig, cache: Cache,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,) -> (logits (B, V) float32, cache).

    Each layer writes its new K/V into its slice of the pools in place;
    the returned cache holds the same pool tensors and ``len + 1``."""
    x = embed(params.embed, tokens[:, None])
    cache_len = cache["len"]
    bt = cache["block_tables"]
    for i, blk in enumerate(params.blocks):
        x = block_decode(blk, x, cfg, cache["k_pages"][i],
                         cache["v_pages"][i], bt, cache_len)
    x = apply_norm(params.final_norm, x)
    logits = lm_logits(params.embed, x[:, 0], cfg)
    new_cache = dict(cache)
    new_cache["len"] = cache_len + 1
    return logits, new_cache


@torch.no_grad()
def lm_decode_n_steps(params: LM, cfg: ModelConfig, cache: Cache,
                      tokens: torch.Tensor, remaining: torch.Tensor,
                      tok_idx: torch.Tensor, *, n_steps: int,
                      temperature: float = 0.0, len_cap: int = 0):
    """Advance every lane ``n_steps`` greedy tokens with no host sync.

    ``remaining`` (B,) int32 is each lane's generation budget; exhausted
    lanes keep stepping (their writes land on pages the engine points at
    a scratch page) but their samples are flagged invalid, their token
    index stops advancing and their cache length is frozen.
    ``len_cap`` > 0 zeroes the budget once the length reaches it (the
    engine passes ``max_len - 1``).  Same semantics as the reference's
    ``lm_decode_n_steps``; greedy only.

    Returns (tokens (n, B) int32, valid (n, B) bool, next_tokens (B,),
    cache, remaining, tok_idx), all on the device.
    """
    if temperature > 0.0:
        raise ValueError(f"temperature sampling is not ported yet: it "
                         f"comes with {RNG_SLICE}")
    b = tokens.shape[0]
    toks = torch.empty((n_steps, b), dtype=torch.int32, device=tokens.device)
    valid = torch.empty((n_steps, b), dtype=torch.bool, device=tokens.device)
    tok, rem, idx = tokens, remaining, tok_idx
    for step in range(n_steps):
        live = rem > 0
        len_before = cache["len"]
        logits, cache = lm_decode_step(params, cfg, cache, tok)
        cache["len"] = torch.where(live, cache["len"], len_before)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        rem = torch.where(live, rem - 1, torch.zeros_like(rem))
        if len_cap > 0:
            rem = torch.where(cache["len"] >= len_cap,
                              torch.zeros_like(rem), rem)
        idx = idx + live.to(torch.int32)
        toks[step] = tok
        valid[step] = live
    return toks, valid, tok, cache, rem, idx
