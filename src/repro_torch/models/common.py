"""Shared model substrate: config, norms, RoPE, embedding, LM head, init.

Port of the reference's ``models/common.py`` for every family it
serves (dense, moe, ssm, hybrid, vlm and the whisper encoder-decoder),
with its three norms (RMSNorm, LayerNorm and OLMo's LayerNorm without
an affine).
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
from torch.nn import functional as F

from repro_torch.parallel import sharding

VOCAB_ALIGN = 256  # Megatron convention: pad vocab for clean TP sharding

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pad_vocab(v: int, align: int = VOCAB_ALIGN) -> int:
    return (v + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts widths, as the reference's ``MoEConfig``."""

    n_experts: int
    top_k: int
    d_expert_ff: int
    capacity_factor: float = 1.25
    dense_residual: bool = False   # Arctic: dense FFN in parallel with MoE
    n_shared_experts: int = 0      # Moonlight/DeepSeek style
    router_aux_weight: float = 0.01


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
    """The reference ``ModelConfig`` without its ``use_pallas`` switch
    (the port picks kernels by device)."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # or "layernorm", "nonparametric_ln"
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    max_seq_len: int = 131072
    sliding_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    # vlm: number of prefix vision tokens the stub frontend provides
    n_vision_tokens: int = 0
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
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        """No attention, so no KV cache (the ssm family)."""
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        """Mamba-2 layers, so per-lane recurrent state (ssm and hybrid)."""
        return self.family in ("ssm", "hybrid")

    def active_params_per_layer(self) -> float:
        """Active (per-token) parameter count of one block, the
        reference's formula (the dry run's ``model_flops``)."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.family == "ssm":
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            return 2 * d * d_in + d_in * d + d_in * (2 * s.state_dim)
        mlp = 3 * d * self.d_ff
        if self.moe is not None:
            m = self.moe
            mlp = 3 * d * m.d_expert_ff * (m.top_k + m.n_shared_experts)
            if m.dense_residual:
                mlp += 3 * d * self.d_ff
        if self.family == "hybrid":
            s = self.ssm or SSMConfig()
            d_in = s.d_inner_override or (s.expand * d)
            return attn + mlp + 2 * d * d_in + d_in * d
        return attn + mlp

    def active_params(self) -> float:
        body = self.n_layers * self.active_params_per_layer()
        emb = self.d_model * self.padded_vocab
        if not self.tie_embeddings:
            emb *= 2
        return body + emb

    def total_params(self) -> float:
        per = self.active_params_per_layer()
        if self.moe is not None:
            m = self.moe
            d = self.d_model
            per = (per - 3 * d * m.d_expert_ff * (m.top_k + m.n_shared_experts)
                   + 3 * d * m.d_expert_ff * (m.n_experts
                                              + m.n_shared_experts))
        body = self.n_layers * per
        emb = self.d_model * self.padded_vocab * (1 if self.tie_embeddings
                                                  else 2)
        return body + emb


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


def trainable(module: nn.Module) -> nn.Module:
    """``module`` with every parameter tracked by autograd (training);
    serving's parameters stay :func:`frozen`."""
    return module.requires_grad_(True)


#: top-level parameter groups the reference stacks along a layer axis
STACKED = ("blocks", "encoder", "decoder")


def reference_path(name: str) -> Tuple[str, Optional[int]]:
    """A port parameter's leaf in the reference's tree: ``("blocks/attn/
    wq", 3)`` for ``"blocks.3.attn.wq"`` (layer 3 of the stacked ``(L,
    ...)`` leaf), ``("embed/tok", None)`` for ``"embed.tok"``."""
    parts = name.split(".")
    if parts[0] in STACKED and len(parts) > 2 and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), None


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------

class RMSNorm(nn.Module):
    """Scale kept float32; the normalisation runs in float32 inside."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = frozen(torch.ones(d, dtype=torch.float32,
                                       device=device))


class LayerNorm(nn.Module):
    """Scale (ones) and bias (zeros), both float32, as the reference's
    ``init_norm`` for ``"layernorm"``."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = frozen(torch.ones(d, dtype=torch.float32,
                                       device=device))
        self.bias = frozen(torch.zeros(d, dtype=torch.float32,
                                       device=device))


class NonParametricLN(nn.Module):
    """OLMo's LayerNorm without a learned affine: no parameters (the
    reference's ``init_norm`` gives ``{}``)."""


_NORMS = {"rmsnorm": RMSNorm, "layernorm": LayerNorm,
          "nonparametric_ln": NonParametricLN}


def make_norm(cfg: ModelConfig, device=None) -> nn.Module:
    """The norm module ``cfg.norm`` names, over ``cfg.d_model``."""
    if cfg.norm not in _NORMS:
        raise ValueError(f"unknown norm {cfg.norm!r}")
    cls = _NORMS[cfg.norm]
    return cls() if cls is NonParametricLN else cls(cfg.d_model, device)


def apply_norm(p: nn.Module, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """The reference's ``apply_norm``, the kind given by ``p``'s type:
    float32 inside, the result cast back to ``x``'s dtype.  LayerNorm's
    variance is the mean of ``(x - mean)^2`` (population, two passes),
    as ``jnp.var``; ``torch.var`` would divide by ``n - 1``."""
    xf = x.float()
    if isinstance(p, RMSNorm):
        rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf / rms * sharding.weight(p.scale, None).float()
                ).to(x.dtype)
    centered = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    if isinstance(p, LayerNorm):
        y = y * sharding.weight(p.scale, None).float() + \
            sharding.weight(p.bias, None).float()
    return y.to(x.dtype)


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


def embed(p: Embedding, tokens: torch.Tensor, *, train: bool = False
          ) -> torch.Tensor:
    """The token rows of ``tokens``.  ``train`` looks them up with
    ``F.embedding``, whose backward sums each row's cotangents in a
    fixed order (the indexing backward accumulates atomically, and its
    float32 sums vary run to run); serving indexes the table.

    On a mesh whose ``tp`` axes split the vocab (Megatron's
    vocab-parallel embedding), each rank looks up the tokens in its
    block of rows, zero elsewhere, and the blocks' rows are summed over
    those axes: one nonzero term a token, so the sum is the row."""
    ids = tokens.long()

    def lookup(table, i):
        return F.embedding(i, table) if train else table[i]

    axes = sharding.axes_of(p.tok, 0)
    if not axes:
        return lookup(sharding.weight(p.tok, None, None), ids)
    tok = sharding.weight(p.tok, ..., None)
    v0, v1 = sharding.block_of(tok.shape[0] * sharding.extent(axes), axes)
    local = ids - v0
    inside = (local >= 0) & (local < v1 - v0)
    rows = lookup(tok, torch.where(inside, local, torch.zeros_like(local)))
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return sharding.reduce_out(rows, axes)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in float32 (the reference's): logsumexp
    minus the gold logit, a masked mean when ``mask`` is given.  The gold
    logit is a gather; the reference's one-hot product only serves its
    sharding, and at full width a one-hot of the logits' shape would be
    ~1.2 GB."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def vocab_axes(p: Embedding, cfg: ModelConfig):
    """The mesh axes the LM head's vocab dim is stored over (none with
    no mesh)."""
    if cfg.tie_embeddings:
        return sharding.axes_of(p.tok, 0)
    return sharding.axes_of(p.head, 1)


def cross_entropy_split(logits: torch.Tensor, labels: torch.Tensor,
                        mask: Optional[torch.Tensor], axes, v0: int,
                        batch_axes) -> torch.Tensor:
    """This rank's share of :func:`cross_entropy` on a mesh: ``logits``
    (rows, V / n) float32 hold vocab ``[v0, v0 + V / n)`` of this rank's
    rows, split over ``axes``; the rows are split over ``batch_axes``.
    The max, the exponentials' sum and the gold logit are reduced over
    the vocab axes (Megatron's vocab-parallel cross-entropy); the
    returned value is this rank's rows' summed loss over the count of
    every rank's (masked) tokens, so the shares sum over the batch axes
    to the loss, and each rank's gradient is its rows'."""
    m = sharding.all_reduce(torch.amax(logits.detach(), dim=-1), axes,
                            op="max")
    s = sharding.reduce_out(torch.sum(torch.exp(logits - m[..., None]),
                                      dim=-1), axes)
    logz = torch.log(s) + m
    local = labels.long() - v0
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(
        inside, local, torch.zeros_like(local))[..., None])[..., 0]
    gold = sharding.reduce_out(
        torch.where(inside, gold, torch.zeros_like(gold)), axes)
    nll = logz - gold
    if mask is None:
        count = torch.full((), float(nll.numel() * sharding.extent(
            batch_axes)), dtype=torch.float32, device=nll.device)
        return torch.sum(nll) / count
    count = sharding.all_reduce(torch.sum(mask).detach().float(),
                                batch_axes)
    return torch.sum(nll * mask) / torch.clamp(count, min=1.0)


def token_loss(p: Embedding, logits: torch.Tensor, labels: torch.Tensor,
               mask: Optional[torch.Tensor], cfg: ModelConfig
               ) -> torch.Tensor:
    """The next-token loss of :func:`lm_logits`' ``logits``: with no mesh
    :func:`cross_entropy`; on a mesh this rank's share
    (:func:`cross_entropy_split`, ``logits`` this rank's rows and block
    of the vocab)."""
    if sharding.active() is None:
        return cross_entropy(logits, labels, mask)
    axes = vocab_axes(p, cfg)
    v0 = sharding.block_of(cfg.padded_vocab, axes)[0]
    return cross_entropy_split(logits, labels, mask, axes, v0,
                               sharding.batch_split_axes())


def lm_logits(p: Embedding, x: torch.Tensor, cfg: ModelConfig, *,
              local: bool = False) -> torch.Tensor:
    """Final projection with the padded vocab masked to -1e30 (float32).

    On a mesh whose axes split the vocab the projection is
    column-parallel: each rank's logits are its block of the vocab,
    gathered whole unless ``local`` (the training loss reads the
    blocks)."""
    axes = vocab_axes(p, cfg)
    if cfg.tie_embeddings:
        w = sharding.weight(p.tok, ..., None).t()
    else:
        w = sharding.weight(p.head, None, ...)
    logits = torch.matmul(sharding.copy_in(x, axes), w).float()
    v0, v1 = sharding.block_of(cfg.padded_vocab, axes)
    if v1 > cfg.vocab_size:
        logits[..., max(cfg.vocab_size - v0, 0):] = -1e30
    if axes and not local:
        logits = sharding.relayout(logits, logits.dim() - 1, axes, None)
    return logits
