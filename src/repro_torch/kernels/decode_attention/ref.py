"""Plain PyTorch versions of dense and paged decode attention, over a
cache in q's dtype or an int8 cache with f32 scales (the reference's
``kernels/decode_attention/ref.py`` oracles)."""

from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, kv_lengths, *, scale=None):
    """q: (B, H, D); k/v: (B, Hkv, S, D); kv_lengths: (B,).

    GQA is computed grouped (q viewed as (B, Hkv, G, D)); softmax over
    the positions ``< kv_lengths[b]``; a lane with no live key outputs
    0.  The plain version of both K3 and K6a.  q is scaled in float32,
    as the kernels and the reference scale it; the rest runs in float64
    with elementwise products and sums, and is rounded once to q's
    dtype, so the result does not depend on a BLAS library's kernels
    (the first MKL batched product of a loaded test worker once came
    out of one of its threads with ~5e-5 errors in the scores).
    """
    b, h, d = q.shape
    _, hkv, sk, _ = k.shape
    group = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    qg = (q.reshape(b, hkv, group, d).float() * scale).double()
    s = (qg[:, :, :, None, :] * k.double()[:, :, None]).sum(-1)
    pos = torch.arange(sk, device=q.device)
    mask = pos[None, None, None, :] < kv_lengths[:, None, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    denom = torch.sum(p, dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = (p[..., None] * v.double()[:, :, None]).sum(-2) / denom
    return out.reshape(b, h, d).to(q.dtype)


def split_partials(q, k, v, kv_lengths, *, ch: int, scale=None):
    """The split kernels' first step in plain PyTorch: the cache cut into
    chunks of ``ch`` positions, and per (lane, kv head, chunk, head of
    the group) a block softmax over the chunk's live positions.

    Returns (m, l, acc): (B, Hkv, n_chunks, G) running max and sum and
    (B, Hkv, n_chunks, G, D) weighted values, float32, each rounded once
    from float64 as in :func:`decode_attention_ref`.  A chunk with no
    live position gives m = -1e30 and l = acc = 0 exactly.
    """
    b, h, d = q.shape
    _, hkv, s, _ = k.shape
    group = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    n = -(-s // ch)
    pad = (0, 0, 0, n * ch - s)
    kc = torch.nn.functional.pad(k.double(), pad).reshape(b, hkv, n, ch, d)
    vc = torch.nn.functional.pad(v.double(), pad).reshape(b, hkv, n, ch, d)
    qg = (q.reshape(b, hkv, group, d).float() * scale).double()
    sc = (qg[:, :, None, :, None, :] * kc[:, :, :, None]).sum(-1)
    pos = torch.arange(n * ch, device=q.device).reshape(n, ch)
    live = pos[None] < kv_lengths.clamp(0, s)[:, None, None]   # (B, n, ch)
    live = live[:, None, :, None, :]
    sc = torch.where(live, sc, torch.full_like(sc, -1e30))
    m = torch.amax(sc, dim=-1)
    p = torch.where(live, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    acc = (p[..., None] * vc[:, :, :, None]).sum(-2)
    return m.float(), p.sum(dim=-1).float(), acc.float()


def merge_partials(m, l, acc, dtype):
    """The dense kernels' merge: the chunks' partials folded in chunk
    order into (B, H, D) of ``dtype``; a lane with no live key gives 0."""
    b, hkv, n, group, d = acc.shape
    mx = torch.amax(m, dim=2)
    lsum = torch.zeros_like(mx)
    out = torch.zeros_like(acc[:, :, 0])
    for c in range(n):
        f = torch.exp(m[:, :, c] - mx)
        lsum = lsum + l[:, :, c] * f
        out = out + acc[:, :, c] * f[..., None]
    denom = torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)
    return (out / denom[..., None]).reshape(b, hkv * group, d).to(dtype)


def decode_attention_split_ref(q, k, v, kv_lengths, *, ch: int,
                               scale=None):
    """:func:`decode_attention_ref` computed as the dense kernels compute
    it: :func:`split_partials`, then :func:`merge_partials`."""
    return merge_partials(*split_partials(q, k, v, kv_lengths, ch=ch,
                                          scale=scale), q.dtype)


def dequant_kv_q8(k_q, k_scale, qblock: int = 32):
    """(B, Hkv, S, D) int8 + (B, Hkv, S/qblock, 1) f32 -> f32 KV."""
    if qblock != 1:
        k_scale = torch.repeat_interleave(k_scale, qblock, dim=2)
    return k_q.float() * k_scale


def quantize_kv_q8(k, qblock: int = 32):
    """Per-(head, qblock-key-block) symmetric int8 KV quantization.
    k: (B, Hkv, S, D) -> (int8 values, f32 scales (B, Hkv, S/qblock, 1))."""
    b, hkv, s, d = k.shape
    kb = k.float().reshape(b, hkv, s // qblock, qblock, d)
    amax = torch.amax(kb.abs(), dim=(3, 4), keepdim=True)
    scale = (amax / 127.0).reshape(b, hkv, s // qblock, 1)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    kq = torch.clamp(torch.round(kb / scale[..., None, :]), -127, 127
                     ).to(torch.int8)
    return kq.reshape(b, hkv, s, d), scale


def decode_attention_q8_ref(q, k_q, k_scale, v_q, v_scale, kv_lengths, *,
                            scale=None, qblock: int = 32):
    """Dense int8 decode: dequantize, then :func:`decode_attention_ref`.
    The plain version of both K5 and K6b."""
    k = dequant_kv_q8(k_q, k_scale, qblock)
    v = dequant_kv_q8(v_q, v_scale, qblock)
    return decode_attention_ref(q, k, v, kv_lengths, scale=scale)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """pages: (P, Hkv, ps, D); block_tables: (B, T) physical page ids in
    logical order -> each lane's logical view (B, Hkv, T*ps, D), a
    contiguous copy (a dense kernel can take it)."""
    g = pages[block_tables.long()]                 # (B, T, Hkv, ps, D)
    b, t, hkv, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, t * ps, d).contiguous()


def decode_attention_paged_ref(q, k_pages, v_pages, block_tables,
                               kv_lengths, *, scale=None):
    """q: (B, H, D); pools (P, Hkv, ps, D); block_tables (B, T)."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    return decode_attention_ref(q, k, v, kv_lengths, scale=scale)


def decode_attention_paged_q8_ref(q, k_pages, k_scale_pages, v_pages,
                                  v_scale_pages, block_tables, kv_lengths,
                                  *, scale=None, qblock: int = 32):
    """Paged int8 decode (the plain version of K4); scale pools are
    (P, Hkv, ps/qblock, 1)."""
    k = dequant_kv_q8(gather_pages(k_pages, block_tables),
                      gather_pages(k_scale_pages, block_tables), qblock)
    v = dequant_kv_q8(gather_pages(v_pages, block_tables),
                      gather_pages(v_scale_pages, block_tables), qblock)
    return decode_attention_ref(q, k, v, kv_lengths, scale=scale)


def decode_attention_paged_split_ref(q, k_pages, v_pages, block_tables,
                                     kv_lengths, *, ch: int, scale=None):
    """K1 as the paged kernel computes it: the dense kernels' chunked
    block softmax and merge (:func:`decode_attention_split_ref`) over
    each lane's logical view (:func:`gather_pages`), S = T*ps.  The
    paged kernel differs from the dense one only in where it finds a
    row, so on the card K1 equals K3 on the gathered pools bit for bit."""
    return decode_attention_split_ref(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), kv_lengths, ch=ch, scale=scale)


def decode_attention_paged_q8_split_ref(q, k_pages, k_scale_pages, v_pages,
                                        v_scale_pages, block_tables,
                                        kv_lengths, *, ch: int, scale=None,
                                        qblock: int = 32):
    """K4 as the paged kernel computes it: each int8 element times its
    scale in f32 (the product the kernel makes), then
    :func:`decode_attention_paged_split_ref`'s chunks over the gathered
    view; the plain version of K5 over that view too."""
    k = dequant_kv_q8(gather_pages(k_pages, block_tables),
                      gather_pages(k_scale_pages, block_tables), qblock)
    v = dequant_kv_q8(gather_pages(v_pages, block_tables),
                      gather_pages(v_scale_pages, block_tables), qblock)
    return decode_attention_split_ref(q, k, v, kv_lengths, ch=ch,
                                      scale=scale)
