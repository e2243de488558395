"""Shared model substrate: config, RMSNorm, RoPE, embedding, LM head, init.

Port of the dense-, ssm- and hybrid-family parts of the reference's
``models/common.py``.
Parameters live in ``nn.Module``s (one module per layer, no stacked
``(L, ...)`` leaves); weight matrices keep the reference layout
``(d_in, d_out)``.  Matrices, biases and the embedding are stored in the
compute dtype once at load, which gives the same values as the
reference's ``astype(x.dtype)`` at each use; norm scales stay float32,
as the reference reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

VOCAB_ALIGN = 256  # Megatron convention: pad vocab for clean TP sharding

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pad_vocab(v: int, align: int = VOCAB_ALIGN) -> int:
    return (v + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block widths, as the reference's ``SSMConfig``."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    # fraction of d_model given to the SSM branch in hybrid blocks
    d_inner_override: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The dense-decoder, ssm and hybrid fields of the reference
    ``ModelConfig``."""

    name: str
    family: str                    # "dense", "ssm" or "hybrid"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # this slice serves "rmsnorm" only
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    max_seq_len: int = 131072
    sliding_window: Optional[int] = None
    ssm: Optional[SSMConfig] = None
    dtype: str = "bfloat16"
    kv_quant: Optional[str] = None  # "int8": int8 KV cache, f32 scales

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def attn_free(self) -> bool:
        """No attention, so no KV cache (the ssm family)."""
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        """Mamba-2 layers, so per-lane recurrent state (ssm and hybrid)."""
        return self.family in ("ssm", "hybrid")


# ----------------------------------------------------------------------
# Initialization
# ----------------------------------------------------------------------

def dense_init(shape, generator: torch.Generator, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init in float32, as the
    reference's ``dense_init``.  The bits differ from ``jax.random``'s:
    a test that compares the two frameworks converts the reference's
    parameters instead (``repro_torch.convert``)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """Inference parameter: no autograd tracking."""
    return nn.Parameter(t, requires_grad=False)


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------

class RMSNorm(nn.Module):
    """Scale kept float32; the normalisation runs in float32 inside."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = frozen(torch.ones(d, dtype=torch.float32,
                                       device=device))


def apply_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf / rms * p.scale.float()).to(x.dtype)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a fill, not a host tensor copied over: capturable in a CUDA graph
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D//2) broadcast over heads.
    Rotate-half convention (llama / qwen), float32 arithmetic."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1
                     ).to(x.dtype)


# ----------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------

class Embedding(nn.Module):
    """Token table ``tok`` (padded_vocab, d); ``head`` (d, padded_vocab)
    only when the embeddings are not tied."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.compute_dtype
        self.tok = frozen(torch.zeros(cfg.padded_vocab, cfg.d_model,
                                      dtype=dt, device=device))
        if not cfg.tie_embeddings:
            self.head = frozen(torch.zeros(cfg.d_model, cfg.padded_vocab,
                                           dtype=dt, device=device))


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.tok[tokens.long()]


def lm_logits(p: Embedding, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """Final projection with the padded vocab masked to -1e30 (float32)."""
    w = p.tok.t() if cfg.tie_embeddings else p.head
    logits = torch.matmul(x, w).float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
