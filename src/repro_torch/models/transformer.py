"""Decoder-only LM, dense, moe, ssm, hybrid and vlm families:
full-sequence forward, prompt prefill (batched, and streamed through
the decode step), dense and paged caches, decode step, on-device
sampling and the multi-step decode dispatch.  Port of
the reference's ``models/transformer.py``.  A moe block routes its FFN
through :mod:`repro_torch.models.moe` (Arctic's dense residual FFN
beside it); a vlm model is the dense decoder whose first positions can
take precomputed vision embeddings (``vision_embeds``) in place of the
token embeddings.

The reference stacks layers along a leading axis and runs them with
``lax.scan``; here each layer is its own module in a ``ModuleList`` and
a Python loop walks them.  Both caches keep the reference layouts --
dense ``(L, B, Hkv, S, D)``, paged pool ``(L, P, Hkv, ps, D)``, in the
compute dtype or, with ``kv_quant="int8"``, in int8 beside f32
per-token scales with a trailing 1 -- and are updated in place.  An ssm
(Mamba-2) model has no K/V: its caches hold the recurrent state
``ssm_h`` (L, B, nh, N, P) and conv window ``ssm_conv`` (L, B, W-1,
conv_ch), float32, on either layout (a paged ssm cache has no pages and
no block tables).  A hybrid (Hymba) model runs attention and Mamba-2
side by side in every block, so its caches hold both: the K/V (a ring
of the sliding window, dense or through the block table) and the dense
per-lane state.

On a mesh of more than one rank (:mod:`repro_torch.parallel.sharding`)
the dense family trains and decodes sharded: the training forward takes
this rank's rows of the batch, the decode step the whole batch and a
cache placed by ``place_cache`` (``init_cache`` places it).  Every
other family, the batched prefill and the paged cache refuse a mesh by
name.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import rng as trng
from repro_torch.analysis.invariants import invariant
from repro_torch.models.attention import (Attention, attention_decode,
                                          attention_decode_paged,
                                          attention_forward)
from repro_torch.models.common import (Embedding, ModelConfig, apply_norm,
                                       cross_entropy, cross_entropy_split,
                                       dense_init, embed, lm_logits,
                                       make_norm, vocab_axes)
from repro_torch.models.mlp import SwiGLU, swiglu
from repro_torch.models.moe import MoE, moe_forward
from repro_torch.models.ssm import (Mamba2, init_mamba2, init_mamba2_state,
                                    mamba2_decode, mamba2_forward)
from repro_torch.parallel import comm, sharding

Cache = Dict[str, torch.Tensor]

#: decoder families the port serves (the encoder-decoder is
#: :mod:`repro_torch.models.whisper`)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
#: norms the port serves
NORMS = ("rmsnorm", "layernorm", "nonparametric_ln")


def check_family(cfg: ModelConfig) -> None:
    """The port's decoders are the families ``FAMILIES`` with any of the
    reference's three norms (a moe config carries its ``MoEConfig``);
    every other decoder is refused by name."""
    if cfg.family not in FAMILIES or cfg.norm not in NORMS or \
            (cfg.family == "moe") != (cfg.moe is not None):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with norm "
                         f"{cfg.norm!r} and moe {cfg.moe} is not a decoder "
                         f"the port has (the families {FAMILIES}, a "
                         f"MoEConfig exactly for moe, the norms {NORMS})")


# ----------------------------------------------------------------------
# Modules + init
# ----------------------------------------------------------------------

class Block(nn.Module):
    """Dense and vlm: ``norm1``, ``attn``, ``norm2``, ``mlp``; moe:
    ``moe`` in place of ``mlp`` (and ``mlp`` beside it with a dense
    residual); ssm: ``norm1`` and ``ssm`` only; hybrid: ``norm1``,
    ``attn``, ``ssm``, ``norm2``, ``mlp``; as the reference's
    ``init_block``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = make_norm(cfg, device)
        if cfg.attn_free:
            self.ssm = Mamba2(cfg, device)
            return
        self.attn = Attention(cfg, device)
        if cfg.has_ssm:
            self.ssm = Mamba2(cfg, device)
        self.norm2 = make_norm(cfg, device)
        if cfg.moe is not None:
            self.moe = MoE(cfg.d_model, cfg.moe, cfg.compute_dtype, device)
        if cfg.moe is None or cfg.moe.dense_residual:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, cfg.compute_dtype,
                              device)


class LM(nn.Module):
    """Parameters of a decoder: ``embed``, ``blocks``, ``final_norm`` --
    the reference's param tree, one module per layer."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.embed = Embedding(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = make_norm(cfg, device)


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device: torch.device) -> LM:
    """Random weights with the reference's init scheme (fan-in truncated
    normal over the first axis -- an expert stack's is E, as there --,
    0.02 embedding and router, zero biases, unit norms; ``init_mamba2``'s
    for an ssm block and a hybrid block's ``ssm``), drawn in float32 on
    ``device`` from ``generator`` and stored in each parameter's dtype
    (the compute dtype; a router stays float32).  The values differ
    from ``jax.random``'s for the same seed."""
    lm = LM(cfg, device)
    dt = cfg.compute_dtype
    lm.embed.tok.copy_(dense_init(tuple(lm.embed.tok.shape), generator,
                                  device, scale=0.02).to(dt))
    if not cfg.tie_embeddings:
        lm.embed.head.copy_(dense_init(tuple(lm.embed.head.shape),
                                       generator, device).to(dt))
    for blk in lm.blocks:
        if cfg.attn_free:
            init_mamba2(blk.ssm, generator)
            continue
        for name, w in blk.named_parameters():
            # matrices and expert stacks; biases and norms stay as made
            if w.dim() >= 2 and not name.startswith("ssm."):
                scale = 0.02 if name == "moe.router" else None
                w.copy_(dense_init(tuple(w.shape), generator, device,
                                   scale=scale).to(w.dtype))
        if cfg.has_ssm:
            init_mamba2(blk.ssm, generator)
    return lm


# ----------------------------------------------------------------------
# Prefill
# ----------------------------------------------------------------------

def _hybrid_mix(att: torch.Tensor, ssm: torch.Tensor) -> torch.Tensor:
    """Hymba's combiner of the parallel branches, ``0.5 * (att + ssm)``
    (arXiv:2411.13676, the reference's simplified form): both in the
    compute dtype, the sum rounded there before the halving."""
    return 0.5 * (att + ssm)


def _ffn(p: Block, h2: torch.Tensor, cfg: ModelConfig):
    """The block's feed-forward on the normed stream: (out, aux), aux
    the experts' float32 loss scalar (None without experts).  A moe
    block routes through its experts and adds the dense residual FFN's
    output when it has one."""
    if cfg.moe is None:
        return swiglu(p.mlp, h2), None
    out, aux = moe_forward(p.moe, h2, cfg.moe)
    if cfg.moe.dense_residual:
        out = out + swiglu(p.mlp, h2)
    return out, aux


def block_forward(p: Block, x: torch.Tensor, cfg: ModelConfig):
    """Full-sequence block; returns (x, (k, v), aux), (k, v) None for
    ssm and aux None without experts.  A hybrid block runs attention
    (sliding window, K2) and Mamba-2 (K10) on the same normed input and
    adds their mean."""
    h = apply_norm(p.norm1, x)
    if cfg.attn_free:
        return x + mamba2_forward(p.ssm, h, cfg), None, None
    att, kv = attention_forward(p.attn, h, cfg, return_kv=True)
    if cfg.has_ssm:
        att = _hybrid_mix(att, mamba2_forward(p.ssm, h, cfg))
    x = x + att
    out, aux = _ffn(p, apply_norm(p.norm2, x), cfg)
    return x + out, kv, aux


def _maybe_inject_vision(x: torch.Tensor,
                         vision_embeds: Optional[torch.Tensor],
                         cfg: ModelConfig) -> torch.Tensor:
    """The first ``n`` positions' embeddings replaced by the stub
    frontend's ``vision_embeds`` (B, n, d) (cast to the stream's dtype),
    when the config takes vision tokens; otherwise ``x`` unchanged."""
    if vision_embeds is None or cfg.n_vision_tokens == 0:
        return x
    n = vision_embeds.shape[1]
    return torch.cat([vision_embeds.to(x.dtype), x[:, n:, :]], dim=1)


def _train_block(p: Block, x: torch.Tensor, cfg: ModelConfig):
    x, _, aux = block_forward(p, x, cfg)
    return x, aux


def lm_forward_train(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
                     vision_embeds: Optional[torch.Tensor] = None,
                     remat: bool = False, local_vocab: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``lm_forward``: tokens (B, S) ->
    (logits (B, S, V) float32, aux float32 scalar, the blocks' summed
    experts' loss).  With ``remat`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    dropped after the forward and recomputed in the backward, as
    ``jax.checkpoint`` on the reference's scan body, so a training step
    launches K2 (and K10) twice a layer.  The token lookup is ``F.embedding``:
    the same gather as serving's ``embed``, with a backward that sums
    each row's cotangents in a fixed order (the indexing backward
    accumulates atomically, so its float32 sums vary run to run).  On a
    mesh ``tokens`` are this rank's rows, and ``local_vocab`` keeps the
    logits this rank's block of the vocab (the loss reads them so)."""
    sharding.check_mesh_family(cfg)
    x = _maybe_inject_vision(embed(params.embed, tokens, train=True),
                             vision_embeds, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        if remat:
            x, a = checkpoint(_train_block, blk, x, cfg, use_reentrant=False)
        else:
            x, a = _train_block(blk, x, cfg)
        if a is not None:
            aux = aux + a
    x = apply_norm(params.final_norm, x)
    return lm_logits(params.embed, x, cfg, local=local_vocab), aux


@torch.no_grad()
def lm_forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
               vision_embeds: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Serving's full-sequence pass: tokens (B, S) -> logits (B, S, V)
    float32 at every position, :func:`lm_forward_train`'s logits with no
    autograd record (its attention is K2's plain launch).
    ``vision_embeds`` (B, n, d) takes the place of the first n
    positions' embeddings (vlm)."""
    return lm_forward_train(params, tokens, cfg,
                            vision_embeds=vision_embeds)[0]


def lm_loss(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            remat: bool = False) -> torch.Tensor:
    """The reference's ``lm_loss``: cross-entropy of the next tokens
    ``batch["labels"]`` plus the experts' aux loss (moe), under
    ``batch["loss_mask"]`` when given; a vlm without one masks its
    first ``n_vision_tokens`` positions (they hold
    ``batch["vision_embeds"]``).  Every decoder family trains: attention
    through K2's Function, an ssm or hybrid block's scan through K10's
    (``SSDChunkFn``).  On a mesh the batch is this rank's rows (split
    over ``sharding.split_batch``'s axes) and the value is this rank's
    share of the loss (``cross_entropy_split``)."""
    tokens = batch["tokens"]
    split = sharding.active() is not None
    logits, aux = lm_forward_train(params, tokens, cfg,
                                   vision_embeds=batch.get("vision_embeds"),
                                   remat=remat, local_vocab=split)
    mask = batch.get("loss_mask")
    if mask is None and cfg.n_vision_tokens:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        mask = (pos[None, :] >= cfg.n_vision_tokens).float().expand(
            tokens.shape)
    if split:
        axes = vocab_axes(params.embed, cfg)
        v0 = sharding.block_of(cfg.padded_vocab, axes)[0]
        return cross_entropy_split(logits, batch["labels"], mask, axes, v0,
                                   sharding.batch_split_axes()) + aux
    return cross_entropy(logits, batch["labels"], mask) + aux


@torch.no_grad()
def lm_prefill_batched(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
                       last_pos: Optional[torch.Tensor] = None,
                       vision_embeds: Optional[torch.Tensor] = None):
    """Serving prefill: full-sequence pass returning the last-position
    logits and the KV cache ``(k, v)``, each (L, B, Hkv, S, D) -- or
    ``None`` for an attention-free (ssm) model.  The engine rebuilds an
    ssm or hybrid lane's state by streaming the prompt.

    ``last_pos`` (B,) selects which position's logits to return, so the
    engine can right-pad prompts to a shape bucket (causal attention and
    the causal scan keep positions < last_pos untouched by the
    padding).  A moe model routes every position of the bucket, padding
    included, as the reference does (the capacity counts them all).
    ``vision_embeds`` as in :func:`lm_forward`."""
    if sharding.active() is not None:
        raise ValueError("the batched prefill does not run on a mesh of "
                         "more than one rank (the serving engine has no "
                         "mesh); build a sharded cache with init_cache and "
                         "lm_decode_step")
    x = _maybe_inject_vision(embed(params.embed, tokens), vision_embeds,
                             cfg)
    ks, vs = [], []
    for blk in params.blocks:
        x, kv, _ = block_forward(blk, x, cfg)
        if kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    x = apply_norm(params.final_norm, x)
    if last_pos is None:
        x_last = x[:, -1]
    else:
        idx = last_pos.long().to(x.device)[:, None, None].expand(
            -1, 1, x.shape[-1])
        x_last = torch.gather(x, 1, idx)[:, 0]
    logits = lm_logits(params.embed, x_last, cfg)
    if cfg.attn_free:
        return logits, None
    return logits, (torch.stack(ks), torch.stack(vs))


# ----------------------------------------------------------------------
# KV caches + decode
# ----------------------------------------------------------------------

def paged_capacity(max_len: int, cfg: ModelConfig) -> int:
    """Positions one lane's cache (dense row or block table) must back:
    the window if the config slides, else the full context."""
    win = cfg.sliding_window
    return min(max_len, win) if win else max_len


def _kv_entries(cfg: ModelConfig, shape, names, device) -> Cache:
    """Zeroed K/V tensors of ``shape`` named ``names`` (k, v, k scale, v
    scale): in the compute dtype, or with ``kv_quant="int8"`` int8 plus
    f32 per-token scales of ``shape[:-1] + (1,)`` initialised to ones."""
    if cfg.kv_quant != "int8":
        return {n: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
                for n in names[:2]}
    out = {n: torch.zeros(shape, dtype=torch.int8, device=device)
           for n in names[:2]}
    out.update({n: torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                              device=device) for n in names[2:]})
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device) -> Cache:
    """Dense per-lane decode cache: ``k``/``v`` (L, B, Hkv, S, D) with
    ``S = min(max_len, window)``, and ``len`` (B,) int32; int8 adds
    ``k_scale``/``v_scale`` (L, B, Hkv, S, 1).  An ssm model holds the
    zeroed float32 state of every layer instead: ``ssm_h`` (L, B, nh, N,
    P) and ``ssm_conv`` (L, B, W-1, conv_ch); a hybrid model holds both
    the K/V and that state.  On a mesh of more than one rank the cache
    is this rank's block (``sharding.place_cache``: its lanes and KV
    heads; ``len`` whole)."""
    cache = {"len": torch.zeros(batch, dtype=torch.int32, device=device)}
    if not cfg.attn_free:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads,
                 paged_capacity(max_len, cfg), cfg.hd)
        cache.update(_kv_entries(cfg, shape,
                                 ("k", "v", "k_scale", "v_scale"), device))
    if cfg.has_ssm:
        cache.update(_ssm_entries(cfg, batch, device))
    mesh = sharding.active()
    return cache if mesh is None else sharding.place_cache(mesh, cache, cfg)


def _ssm_entries(cfg: ModelConfig, batch: int, device) -> Cache:
    """Zeroed per-lane recurrent state of every layer: ``ssm_h`` (L, B,
    nh, N, P) and ``ssm_conv`` (L, B, W-1, conv_ch), float32."""
    return {f"ssm_{k}": v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in init_mamba2_state(cfg, batch, device).items()}


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     page_size: int = 16, n_pages: Optional[int] = None,
                     device: torch.device) -> Cache:
    """Paged decode cache: ``k_pages``/``v_pages`` (L, P, Hkv, ps, D)
    shared by all lanes, ``block_tables`` (B, T) int32 page ids in
    logical order (T = capacity / ps, all page 0 until the caller maps
    pages), and ``len`` (B,) int32; int8 adds ``k_scale_pages``/
    ``v_scale_pages`` (L, P, Hkv, ps, 1).  ``n_pages`` defaults to
    ``batch * T``.  An ssm model's recurrent state is O(1) per lane and
    stays dense: ``ssm_h``/``ssm_conv`` and ``len``, no pool and no
    tables; a hybrid model holds the pool and tables beside that dense
    state."""
    if sharding.active() is not None:
        raise ValueError("the paged cache does not run on a mesh of more "
                         "than one rank (the serving engine has no mesh)")
    if cfg.attn_free:
        return init_cache(cfg, batch, max_len, device=device)
    s = paged_capacity(max_len, cfg)
    invariant(s % page_size == 0,
              f"page_size {page_size} must divide cache capacity {s}",
              page_size=page_size, capacity=s)
    bt_width = s // page_size
    if n_pages is None:
        n_pages = batch * bt_width
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.hd)
    cache = {
        "len": torch.zeros(batch, dtype=torch.int32, device=device),
        "block_tables": torch.zeros(batch, bt_width, dtype=torch.int32,
                                    device=device),
    }
    cache.update(_kv_entries(cfg, shape, ("k_pages", "v_pages",
                                          "k_scale_pages", "v_scale_pages"),
                             device))
    if cfg.has_ssm:
        cache.update(_ssm_entries(cfg, batch, device))
    return cache


def block_decode(p: Block, x: torch.Tensor, cfg: ModelConfig,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len: torch.Tensor,
                 block_tables: Optional[torch.Tensor] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 ssm_h: Optional[torch.Tensor] = None,
                 ssm_conv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode through one block. x: (B, 1, d).

    ``block_tables`` (B, T) selects the paged path (``k_cache``/
    ``v_cache`` are this layer's pools); without it they are this
    layer's dense per-lane caches.  ``k_scale``/``v_scale`` are this
    layer's scales when the cache is int8.  A hybrid block also steps
    its Mamba-2 branch on this layer's ``ssm_h``/``ssm_conv`` (updated
    in place) after the attention, and adds the branches' mean."""
    h = apply_norm(p.norm1, x)
    if block_tables is None:
        att = attention_decode(p.attn, h, cfg, k_cache, v_cache, cache_len,
                               k_scale, v_scale)[0]
    else:
        att = attention_decode_paged(p.attn, h, cfg, k_cache, v_cache,
                                     block_tables, cache_len, k_scale,
                                     v_scale)[0]
    if cfg.has_ssm:
        att = _hybrid_mix(att, mamba2_decode(p.ssm, h, cfg, ssm_h, ssm_conv))
    x = x + att
    return x + _ffn(p, apply_norm(p.norm2, x), cfg)[0]


@torch.no_grad()
def lm_decode_step(params: LM, cfg: ModelConfig, cache: Cache,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,) -> (logits (B, V) float32, cache).

    A cache with ``block_tables`` is paged, one without is dense (as the
    reference's ``_attn_decode`` decides); an int8 cache carries its
    scales beside the values; an ssm cache holds ``ssm_h``/``ssm_conv``,
    a hybrid cache both the K/V and those.
    Each layer writes its new K/V (or state) into its slice of the cache
    in place; the returned cache holds the same tensors and ``len + 1``.

    On a mesh ``tokens`` and the logits are the whole batch on every
    rank and the cache this rank's block (``init_cache``): the step
    runs on its rows of the ``batch`` axes, each attention on the
    cache's lanes and its local heads (K3), and the logits are gathered
    whole."""
    sharding.check_mesh_family(cfg)
    mesh = sharding.active()
    rows = () if mesh is None else sharding.batch_axes(mesh,
                                                       tokens.shape[0])
    if mesh is not None:
        tokens = comm.take(tokens, mesh, 0, rows)
    x = embed(params.embed, tokens[:, None])
    cache_len = cache["len"]
    if cfg.attn_free:
        for i, blk in enumerate(params.blocks):    # state updated in place
            x = x + mamba2_decode(blk.ssm, apply_norm(blk.norm1, x), cfg,
                                  cache["ssm_h"][i], cache["ssm_conv"][i])
    else:
        bt = cache.get("block_tables")
        names = (("k", "v", "k_scale", "v_scale") if bt is None else
                 ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"))
        k_all, v_all, ks_all, vs_all, h_all, conv_all = (
            cache.get(n) for n in names + ("ssm_h", "ssm_conv"))

        def layer(t, i):
            return None if t is None else t[i]

        for i, blk in enumerate(params.blocks):
            x = block_decode(blk, x, cfg, k_all[i], v_all[i], cache_len, bt,
                             layer(ks_all, i), layer(vs_all, i),
                             layer(h_all, i), layer(conv_all, i))
    x = apply_norm(params.final_norm, x)
    logits = sharding.relayout(lm_logits(params.embed, x[:, 0], cfg), 0,
                               rows, None)
    new_cache = dict(cache)
    new_cache["len"] = cache_len + 1
    return logits, new_cache


def sample_tokens(logits: torch.Tensor, key: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """On-device greedy/temperature sampling. logits (B, V) -> (B,) int32.

    ``key`` is one threefry key (2,) for the whole batch, or (B, 2) keys,
    one per lane (the reference's ``sample_tokens_lanes``): each lane
    then draws with its own key, so a request's stream depends only on
    its key lineage and token index."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return trng.categorical(key, logits / temperature).to(torch.int32)


#: per-lane keys need no separate code path: ``categorical`` batches
#: over the leading axes of its key
sample_tokens_lanes = sample_tokens


@torch.no_grad()
def lm_decode_sample_step(params: LM, cfg: ModelConfig, cache: Cache,
                          tokens: torch.Tensor, key: torch.Tensor, *,
                          temperature: float = 0.0
                          ) -> Tuple[torch.Tensor, Cache]:
    """One decode step and the next token sampled on the device: tokens
    (B,) -> (sampled (B,) int32, cache), :func:`lm_decode_step` then
    :func:`sample_tokens` with ``key`` (unused when greedy)."""
    logits, cache = lm_decode_step(params, cfg, cache, tokens)
    return sample_tokens(logits, key, temperature), cache


@torch.no_grad()
def lm_decode_n_steps(params: LM, cfg: ModelConfig, cache: Cache,
                      tokens: torch.Tensor, rng: torch.Tensor,
                      remaining: torch.Tensor, lane_seed: torch.Tensor,
                      tok_idx: torch.Tensor, *, n_steps: int,
                      temperature: float = 0.0, len_cap: int = 0,
                      step_fn=None):
    """Advance every lane ``n_steps`` tokens with no host sync.

    Each lane samples with key ``fold_in(fold_in(rng, lane_seed),
    tok_idx)`` -- ``lane_seed`` is the request's admission index,
    ``tok_idx`` its generated-token count -- so a request's stream is a
    function of its own identity only.  A live lane's token index at
    step ``j`` is ``tok_idx + j`` (a lane that runs out stays out, and
    its samples are discarded), so the Gumbel noise of all ``n_steps``
    is drawn in one batch before the loop: the same draws the
    reference's per-step ``sample_tokens_lanes`` makes, with one
    threefry pass per dispatch instead of one per step (each pass is a
    few hundred small elementwise launches).  Greedy decoding draws
    none.

    ``remaining`` (B,) int32 is each lane's generation budget; exhausted
    lanes keep stepping (their writes land where no live lane reads, and
    an ssm lane's state keeps advancing until re-admission zeroes it) but
    their samples are flagged invalid, their token index stops advancing
    and their cache length is frozen.  ``len_cap`` > 0 zeroes the budget
    once the length reaches it (the engine passes ``max_len - 1``).
    ``step_fn(cache, tokens) -> (logits, cache)`` replaces the decoder's
    step (whisper's, which also reads its cross-attention cache).
    Same semantics as the reference's ``lm_decode_n_steps``.

    Returns (tokens (n, B) int32, valid (n, B) bool, next_tokens (B,),
    cache, remaining, tok_idx), all on the device.
    """
    b = tokens.shape[0]
    toks = torch.empty((n_steps, b), dtype=torch.int32, device=tokens.device)
    valid = torch.empty((n_steps, b), dtype=torch.bool, device=tokens.device)
    sampling = temperature > 0.0
    if sampling:
        steps = torch.arange(n_steps, dtype=torch.int32,
                             device=tokens.device)[:, None]
        keys = trng.fold_in(trng.fold_in(rng, lane_seed)[None],
                            tok_idx[None] + steps)           # (n, B, 2)
        noise = trng.gumbel(keys, (cfg.padded_vocab,))      # (n, B, V)
    if step_fn is None:
        def step_fn(c, t):
            return lm_decode_step(params, cfg, c, t)
    tok, rem, idx = tokens, remaining, tok_idx
    for step in range(n_steps):
        live = rem > 0
        len_before = cache["len"]
        logits, cache = step_fn(cache, tok)
        cache["len"] = torch.where(live, cache["len"], len_before)
        if sampling:    # sample_tokens_lanes with this step's noise
            tok = torch.argmax(noise[step] + logits / temperature,
                               dim=-1).to(torch.int32)
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        rem = torch.where(live, rem - 1, torch.zeros_like(rem))
        if len_cap > 0:
            rem = torch.where(cache["len"] >= len_cap,
                              torch.zeros_like(rem), rem)
        idx = idx + live.to(torch.int32)
        toks[step] = tok
        valid[step] = live
    return toks, valid, tok, cache, rem, idx


@torch.no_grad()
def lm_prefill(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
               max_len: int, vision_embeds: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Cache]:
    """Build a dense decode cache by streaming the prompt one token at a
    time: tokens (B, S) through :func:`lm_decode_step` from a fresh
    :func:`init_cache` of ``max_len`` on the tokens' device.  Returns
    the last step's logits (B, V) and the cache (``len`` = S).

    The simple, functional route, as in the reference: the serving
    engine prefills through :func:`lm_prefill_batched` and keeps this
    one for tests.  ``vision_embeds`` is accepted and never read, as in
    the reference (the decode step embeds tokens only)."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    logits = None
    for t in range(s):
        logits, cache = lm_decode_step(params, cfg, cache, tokens[:, t])
    return logits, cache
