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
the port, on a mesh as without one.

Training (:func:`whisper_loss`) runs :func:`encode_train` and
:func:`decode_forward_train`, each block under ``torch.utils.
checkpoint`` with ``remat`` (the reference's ``jax.checkpoint`` on its
scan body), every attention through K2's Function when autograd
records; serving's :func:`encode` and :func:`decode_forward` are the
same passes with no autograd record.

On a mesh of more than one rank (:mod:`repro_torch.parallel.sharding`)
every attention is split by heads as the decoder-only families' is
(``models/attention.py``), cross-attention too: its query from the
decoder stream and its K/V from the encoder states at this rank's
heads, each input through ``copy_in`` (every decoder layer reads the
encoder states, so their gradient sums over the heads' axes once a
layer), the output row-parallel.  The GELU MLPs are column- then
row-parallel, the token lookup and the logits vocab-parallel and the
loss :func:`~repro_torch.models.common.cross_entropy_split`; training
takes this rank's rows of ``frames``, ``tokens`` and ``labels``.  The
decode cache holds this rank's lanes and heads of every entry, the
cross K/V made from its own columns (:func:`init_whisper_cache`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fn)
from repro_torch.models.attention import (Attention, attention_decode,
                                          attention_forward, local_heads,
                                          project, project_out, project_q)
from repro_torch.models.common import (Embedding, ModelConfig, apply_norm,
                                       dense_init, embed, lm_logits,
                                       make_norm, token_loss)
from repro_torch.models.mlp import GeluMLP, gelu_mlp
from repro_torch.models.transformer import NORMS
from repro_torch.parallel import comm, sharding

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

def _encoder_block(p: EncoderBlock, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    h = apply_norm(p.norm1, x)
    x = x + attention_forward(p.attn, h, cfg, causal=False)
    return x + gelu_mlp(p.mlp, apply_norm(p.norm2, x))


def _run_blocks(block, blocks, x, *args, remat: bool):
    """``x = block(p, x, *args)`` for each layer ``p``, each under a
    (non-reentrant) ``torch.utils.checkpoint`` with ``remat``."""
    for p in blocks:
        if remat:
            x = checkpoint(block, p, x, *args, use_reentrant=False)
        else:
            x = block(p, x, *args)
    return x


def encode_train(params: Whisper, frames: torch.Tensor, cfg: ModelConfig,
                 *, remat: bool = False) -> torch.Tensor:
    """The reference's ``encode``: frames (B, S_enc, d) stub embeddings
    -> encoder states (B, S_enc, d) in the compute dtype,
    differentiable (K2 unmasked through its Function when autograd
    records)."""
    x = _run_blocks(_encoder_block, params.encoder,
                    frames.to(cfg.compute_dtype), cfg, remat=remat)
    return apply_norm(params.enc_final_norm, x)


@torch.no_grad()
def encode(params: Whisper, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """Serving's encoder pass: :func:`encode_train` with no autograd
    record."""
    return encode_train(params, frames, cfg)


def enc_kv(p: Attention, enc: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cross-attention's K/V of the encoder states: (B, Hkv, S_enc, D)
    each at this rank's heads, contiguous (the reference's
    ``_enc_kv``)."""
    b, s, _ = enc.shape
    _, hkv, axes = local_heads(cfg)
    enc = sharding.copy_in(enc, axes)
    k = project(enc, p.wk, p.bk if cfg.qkv_bias else None, axes)
    v = project(enc, p.wv, p.bv if cfg.qkv_bias else None, axes)
    return (k.reshape(b, s, hkv, cfg.hd).transpose(1, 2).contiguous(),
            v.reshape(b, s, hkv, cfg.hd).transpose(1, 2).contiguous())


def cross_attention(p: Attention, x: torch.Tensor, kv, cfg: ModelConfig
                    ) -> torch.Tensor:
    """Unmasked attention of the decoder stream x (B, S, d) into the
    encoder's K/V (``enc_kv``): K2 at Sq = S, Sk = S_enc, through
    ``flash_attention_fn`` when autograd records (as
    ``attention_forward``), its plain launch otherwise."""
    b, s, _ = x.shape
    q = project_q(p, x, cfg).transpose(1, 2).contiguous()
    attend = flash_attention
    if torch.is_grad_enabled() and (q.requires_grad or kv[0].requires_grad
                                    or kv[1].requires_grad):
        attend = flash_attention_fn
    out = attend(q, kv[0], kv[1], causal=False)
    out = out.transpose(1, 2).reshape(b, s, q.shape[1] * cfg.hd)
    return project_out(p, out, cfg)


def _decoder_block(p: DecoderBlock, x: torch.Tensor, enc: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    h = apply_norm(p.norm1, x)
    x = x + attention_forward(p.self_attn, h, cfg, causal=True)
    hx = apply_norm(p.norm_x, x)
    x = x + cross_attention(p.cross_attn, hx, enc_kv(p.cross_attn, enc, cfg),
                            cfg)
    return x + gelu_mlp(p.mlp, apply_norm(p.norm2, x))


def decode_forward_train(params: Whisper, tokens: torch.Tensor,
                         enc: torch.Tensor, cfg: ModelConfig, *,
                         remat: bool = False, local_vocab: bool = False
                         ) -> torch.Tensor:
    """The reference's ``decode_forward``: teacher-forced decoder pass,
    tokens (B, S_dec) over the encoder states ``enc`` -> logits (B,
    S_dec, V) float32, differentiable.  The token lookup is
    ``embed(train=True)``'s ``F.embedding`` (its backward sums in a
    fixed order, as ``lm_forward_train``'s; vocab-parallel on a mesh);
    each layer's cross K/V are made inside its block, so remat
    recomputes them as the reference's does.  ``local_vocab`` keeps the
    logits this rank's block of the vocab (the loss reads them so)."""
    x = _run_blocks(_decoder_block, params.decoder,
                    embed(params.embed, tokens, train=True), enc, cfg,
                    remat=remat)
    x = apply_norm(params.final_norm, x)
    return lm_logits(params.embed, x, cfg, local=local_vocab)


@torch.no_grad()
def decode_forward(params: Whisper, tokens: torch.Tensor, enc: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Serving's teacher-forced pass: :func:`decode_forward_train` with
    no autograd record."""
    return decode_forward_train(params, tokens, enc, cfg)


def whisper_loss(params: Whisper, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, remat: bool = False) -> torch.Tensor:
    """The reference's ``whisper_loss``: ``batch["frames"]`` (B, S_enc,
    d) through :func:`encode_train`, the tokens through
    :func:`decode_forward_train`, and the mean cross-entropy of
    ``batch["labels"]`` under ``batch["loss_mask"]`` when given (no aux
    loss).  On a mesh the batch is this rank's rows (split over
    ``sharding.split_batch``'s axes) and the value is this rank's share
    of the loss (``token_loss``), as ``lm_loss``'s."""
    split = sharding.active() is not None
    enc = encode_train(params, batch["frames"], cfg, remat=remat)
    logits = decode_forward_train(params, batch["tokens"], enc, cfg,
                                  remat=remat, local_vocab=split)
    return token_loss(params.embed, logits, batch["labels"],
                      batch.get("loss_mask"), cfg)


# ----------------------------------------------------------------------
# cached decode
# ----------------------------------------------------------------------

@torch.no_grad()
def init_whisper_cache(params: Whisper, enc: torch.Tensor, cfg: ModelConfig,
                       batch: int, max_len: int) -> Cache:
    """``len`` (B,) int32 at 0, the self-attention cache ``k``/``v`` (L,
    B, Hkv, max_len, D) zeroed, and every layer's cross-attention K/V of
    ``enc`` in ``cross_k``/``cross_v`` (L, B, Hkv, S_enc, D).

    On a mesh of more than one rank ``enc`` is the whole batch's and the
    cache this rank's block (``sharding.cache_layout``): its lanes over
    the ``kv_batch`` axes and its KV heads, the cross K/V made from its
    lanes' encoder states and its heads' columns of ``wk``/``wv`` (no
    whole cache is made or gathered); ``len`` whole."""
    lanes = batch
    mesh = sharding.active()
    if mesh is not None:
        enc = comm.take(enc, mesh, 0, sharding.kv_batch_axes(mesh, batch))
        lanes = enc.shape[0]
    dev = enc.device
    shape = (cfg.n_layers, lanes, local_heads(cfg)[1], max_len, cfg.hd)
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
    tensors and ``len + 1``.

    On a mesh ``tokens`` and the logits are the whole batch on every
    rank and the cache this rank's block (:func:`init_whisper_cache`):
    the step runs on its rows of the ``batch`` axes, each attention, the
    cross-attention too, on the cache's lanes at its local heads (K3),
    and the logits are gathered whole, as ``lm_decode_step``'s."""
    if cfg.kv_quant is not None:
        raise NotImplementedError(
            "int8 KV cache is wired for the decoder-only families; "
            "whisper-base caches are small enough in bf16")
    mesh = sharding.active()
    rows = () if mesh is None else sharding.batch_axes(mesh,
                                                       tokens.shape[0])
    if mesh is not None:
        tokens = comm.take(tokens, mesh, 0, rows)
    cache_len = cache["len"]
    with sharding.split_batch(rows):
        x = embed(params.embed, tokens[:, None])
        enc_len = torch.full((cache["cross_k"].shape[1],),
                             cache["cross_k"].shape[3], dtype=torch.int32,
                             device=tokens.device)
        for i, blk in enumerate(params.decoder):
            h = apply_norm(blk.norm1, x)
            x = x + attention_decode(blk.self_attn, h, cfg, cache["k"][i],
                                     cache["v"][i], cache_len)[0]
            x = x + _cross_decode(blk.cross_attn,
                                  apply_norm(blk.norm_x, x), cfg,
                                  cache["cross_k"][i], cache["cross_v"][i],
                                  enc_len, cache_len.shape[0])
            x = x + gelu_mlp(blk.mlp, apply_norm(blk.norm2, x))
        x = apply_norm(params.final_norm, x)
    logits = sharding.relayout(lm_logits(params.embed, x[:, 0], cfg), 0,
                               rows, None)
    new_cache = dict(cache)
    new_cache["len"] = cache_len + 1
    return logits, new_cache


def _cross_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  k: torch.Tensor, v: torch.Tensor, enc_len: torch.Tensor,
                  n_lanes: int) -> torch.Tensor:
    """One token's cross-attention: x (B, 1, d) -> (B, 1, d) over one
    layer's cross K/V (B, Hkv, S_enc, D), K3 at every lane's full
    encoder length ``enc_len``.  On a mesh x is the step's rows of
    ``n_lanes``, brought to the cache's lanes and back, as
    ``attention_decode`` does."""
    x = sharding.to_lanes(x, n_lanes)
    b = x.shape[0]
    q = project_q(p, x, cfg)[:, 0].contiguous()
    out = decode_attention(q, k, v, enc_len)
    out = project_out(p, out.reshape(b, 1, q.shape[1] * cfg.hd), cfg)
    return sharding.to_lanes(out, n_lanes, back=True)
