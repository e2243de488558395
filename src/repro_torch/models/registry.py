"""Model registry: every family's forward and serving entry points,
bound to a config (the reference's ``models/registry.py``): the decoders
(dense, moe, ssm, hybrid, vlm) through :mod:`~repro_torch.models.
transformer`, the encoder-decoder (whisper) through
:mod:`~repro_torch.models.whisper`."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import transformer, whisper
from repro_torch.models.common import ModelConfig, trainable


def param_module(cfg: ModelConfig, device=None) -> nn.Module:
    """A zero-filled parameter module of ``cfg``'s family, in its
    dtypes: a :class:`~repro_torch.models.whisper.Whisper` for an
    encoder-decoder, else an :class:`~repro_torch.models.transformer.
    LM`.  Each refuses, by name, a config the port does not have."""
    if cfg.is_encdec:
        return whisper.Whisper(cfg, device)
    return transformer.LM(cfg, device)


class Model:
    """Thin dispatcher binding a ModelConfig to its family's functions."""

    def __init__(self, cfg: ModelConfig):
        if cfg.is_encdec:
            whisper.check_encdec(cfg)
        else:
            transformer.check_family(cfg)
        self.cfg = cfg

    def _decoder_only(self, what: str) -> None:
        if self.cfg.is_encdec:
            raise ValueError(f"{self.cfg.name}: {what} is for the decoder-"
                             f"only families; an encoder-decoder runs "
                             f"encode, init_cache(enc=...) and decode_step "
                             f"/ decode_n_steps")

    def init(self, generator: torch.Generator, device: torch.device, *,
             train: bool = False):
        """Random weights from ``generator``.  For serving (the default)
        every weight is stored in the compute dtype and frozen.  With
        ``train`` they are the reference's training parameters: float32
        at every leaf (the master copy; the train step casts them to the
        compute dtype at use) and tracked by autograd; the values are
        the same draws as serving's before its cast.  Every family
        trains."""
        init = (whisper.init_whisper if self.cfg.is_encdec
                else transformer.init_lm)
        if train:
            master = dataclasses.replace(self.cfg, dtype="float32")
            return trainable(init(master, generator, device))
        return init(self.cfg, generator, device)

    def loss(self, params, batch: Dict[str, torch.Tensor],
             remat: bool = False) -> torch.Tensor:
        """Training loss of a batch of device tensors, differentiable in
        ``params``, whose weights are in the compute dtype: a decoder's
        ``transformer.lm_loss``, an encoder-decoder's
        ``whisper.whisper_loss`` (the batch adds ``frames`` (B, S_enc,
        d)), as the reference's registry dispatches."""
        if self.cfg.is_encdec:
            return whisper.whisper_loss(params, batch, self.cfg,
                                        remat=remat)
        return transformer.lm_loss(params, batch, self.cfg, remat=remat)

    def forward(self, params, tokens, *, frames=None, vision_embeds=None):
        """tokens (B, S) -> logits (B, S, V) float32 at every position: a
        decoder's (``vision_embeds`` (B, n, d) in place of the first n
        positions' embeddings for a vlm), or whisper's decoder over
        ``encode(frames)``."""
        if self.cfg.is_encdec:
            if frames is None:
                raise ValueError(f"{self.cfg.name}: forward needs frames")
            enc = whisper.encode(params, frames, self.cfg)
            return whisper.decode_forward(params, tokens, enc, self.cfg)
        return transformer.lm_forward(params, tokens, self.cfg,
                                      vision_embeds=vision_embeds)

    def prefill(self, params, tokens, last_pos=None):
        self._decoder_only("the batched prefill")
        return transformer.lm_prefill_batched(params, tokens, self.cfg,
                                              last_pos=last_pos)

    def init_cache(self, batch: int, max_len: int, *,
                   device: Optional[torch.device] = None, params=None,
                   enc: Optional[torch.Tensor] = None):
        """A decoder's dense cache on ``device``; an encoder-decoder's
        (self-attention ring and cross K/V) from ``params`` and the
        encoder states ``enc``, on ``enc``'s device."""
        if self.cfg.is_encdec:
            if enc is None or params is None:
                raise ValueError("whisper cache needs params and encoder "
                                 "states (enc=)")
            return whisper.init_whisper_cache(params, enc, self.cfg, batch,
                                              max_len)
        return transformer.init_cache(self.cfg, batch, max_len,
                                      device=device)

    def init_paged_cache(self, batch: int, max_len: int, *,
                         page_size: int = 16, n_pages: Optional[int] = None,
                         device: torch.device):
        """Page-pool decode cache; enc-dec caches hold cross-attention
        state and stay dense, as in the reference."""
        self._decoder_only("the paged cache")
        return transformer.init_paged_cache(self.cfg, batch, max_len,
                                            page_size=page_size,
                                            n_pages=n_pages, device=device)

    def decode_step(self, params, cache, tokens):
        if self.cfg.is_encdec:
            return whisper.whisper_decode_step(params, self.cfg, cache,
                                               tokens)
        return transformer.lm_decode_step(params, self.cfg, cache, tokens)

    def decode_n_steps(self, params, cache, tokens, rng, remaining,
                       lane_seed, tok_idx, *, n_steps: int,
                       temperature: float = 0.0, len_cap: int = 0):
        """Multi-token decode dispatch (``transformer.lm_decode_n_steps``)
        for every family with a decode step, the encoder-decoder too."""
        step_fn = None
        if self.cfg.is_encdec:
            def step_fn(c, t):
                return whisper.whisper_decode_step(params, self.cfg, c, t)
        return transformer.lm_decode_n_steps(
            params, self.cfg, cache, tokens, rng, remaining, lane_seed,
            tok_idx, n_steps=n_steps, temperature=temperature,
            len_cap=len_cap, step_fn=step_fn)

    def encode(self, params, frames):
        if not self.cfg.is_encdec:
            raise ValueError(f"{self.cfg.name}: encode is for the "
                             f"encoder-decoder")
        return whisper.encode(params, frames, self.cfg)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
