"""Model registry: the decoders' forward and serving entry points, bound
to a config (the reference's ``models/registry.py``, decoder-only, for
the families the port serves: dense, ssm and hybrid)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


class Model:
    """Thin dispatcher binding a ModelConfig to its family's functions."""

    def __init__(self, cfg: ModelConfig):
        transformer.check_family(cfg)
        self.cfg = cfg

    def init(self, generator: torch.Generator,
             device: torch.device) -> transformer.LM:
        return transformer.init_lm(self.cfg, generator, device)

    def forward(self, params, tokens):
        """tokens (B, S) -> logits (B, S, V) float32 at every position."""
        return transformer.lm_forward(params, tokens, self.cfg)

    def prefill(self, params, tokens, last_pos=None):
        return transformer.lm_prefill_batched(params, tokens, self.cfg,
                                              last_pos=last_pos)

    def init_cache(self, batch: int, max_len: int, *,
                   device: torch.device):
        return transformer.init_cache(self.cfg, batch, max_len,
                                      device=device)

    def init_paged_cache(self, batch: int, max_len: int, *,
                         page_size: int = 16, n_pages: Optional[int] = None,
                         device: torch.device):
        return transformer.init_paged_cache(self.cfg, batch, max_len,
                                            page_size=page_size,
                                            n_pages=n_pages, device=device)

    def decode_step(self, params, cache, tokens):
        return transformer.lm_decode_step(params, self.cfg, cache, tokens)

    def decode_n_steps(self, params, cache, tokens, rng, remaining,
                       lane_seed, tok_idx, *, n_steps: int,
                       temperature: float = 0.0, len_cap: int = 0):
        return transformer.lm_decode_n_steps(
            params, self.cfg, cache, tokens, rng, remaining, lane_seed,
            tok_idx, n_steps=n_steps, temperature=temperature,
            len_cap=len_cap)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
