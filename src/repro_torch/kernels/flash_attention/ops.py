"""Wrapper for the flash attention prefill kernels (K2).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches one of the two kernels of ``csrc/flash_attention.cu`` or
raises -- there is no fallback on the card.  :func:`kernel_for` picks
the kernel from the dtype and head dim alone: bf16 at
``MMA_HEAD_DIMS`` (64, 96 and 128) runs on the tensor cores
(``flash_attention_mma``), everything else (float32, and bf16 at D 32
and 256) on the CUDA cores in f32 (``flash_attention_cc``); each has its
own launch counter.

:class:`FlashAttentionFn` (``flash_attention_fn``) is the same forward
under autograd: on the card it is exactly :func:`flash_attention`'s
launch, and its backward, :func:`attention_backward`, is written out in
PyTorch (the reference differentiates its blockwise attention with
XLA's autodiff, outside any Pallas kernel).  The kernel's output alone
has no ``grad_fn``: a loss through :func:`flash_attention` would treat
attention as a constant on the card.

A ``meta`` tensor (the dry run's shape-only pass,
:mod:`repro_torch.launch.dryrun`) takes :func:`~repro_torch.kernels.
flash_attention.blockwise.blockwise_attention`, so the pass counts
flash-shaped work with no (Sq x Sk) scores; in :func:`attention_backward`
its full chunks, which share one shape, are run once under
:func:`~repro_torch.core.op_analysis.repeated`.  Any other device but
``cpu`` and ``cuda`` is refused.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.op_analysis import repeated
from repro_torch.kernels._build import (KernelLaunchError, LaunchCounter,
                                        bind)
from repro_torch.kernels.flash_attention.blockwise import blockwise_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     live_mask,
                                                     masked_softmax)

__all__ = ["flash_attention", "flash_attention_fn", "FlashAttentionFn",
           "attention_backward", "kernel_for", "COUNTER_MMA", "COUNTER_CC",
           "HEAD_DIMS", "MMA_HEAD_DIMS"]

COUNTER_MMA = LaunchCounter("flash_attention_mma")
COUNTER_CC = LaunchCounter("flash_attention_cc")
#: head dims a kernel is instantiated for (csrc: flash_attention_fwd)
HEAD_DIMS = (32, 64, 96, 128, 256)
#: head dims of the bf16 tensor-core kernel (at 96, phi-3-vision's, a
#: row comes as three 64-byte TMA boxes with the 64-byte swizzle, not
#: 128-byte ones); at 256 its f32 accumulators would not fit in
#: registers, and 32 (the float32 SMOKE configs') no bf16 model serves,
#: so bf16 D 32 and 256 stay on the CUDA cores
MMA_HEAD_DIMS = (64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CODE = {"cc": 0, "mma": 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """``"mma"`` (tensor cores) for bf16 at ``MMA_HEAD_DIMS``, else
    ``"cc"`` (CUDA cores, f32): float32 keeps full f32 products, which
    the float32 tolerance and the token-exact float32 serve need."""
    if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS:
        return "mma"
    return "cc"


def _check(q, k, v, window):
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: kernel "
                        "takes one of float32/bfloat16 for all three")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("want q (B,H,Sq,D) and k/v (B,Hkv,Sk,D)")
    b, h, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d or h % hkv:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if kernel_for(q.dtype, d) == "mma" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the tensor-core kernel reads it by TMA)")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, H, Sq, D).

    GQA maps query head h to KV head h // (H/Hkv); ``window`` keeps keys
    with ``q_pos - k_pos < window``; rows with no live key give 0.
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type == "meta":
        sk = k.shape[2]
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   scale=scale,
                                   block=META_BLOCK if sk % META_BLOCK == 0
                                   else sk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, window)
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    kernel = kernel_for(q.dtype, d)
    out = torch.empty_like(q)
    fn = bind("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, hkv, sq, sk, d, int(bool(causal)),
                -1 if window is None else int(window), scale,
                _DTYPE_CODE[q.dtype], _KERNEL_CODE[kernel], stream)
    if rc != 0:
        raise KernelLaunchError(f"flash_attention ({kernel}): CUDA error "
                                f"{rc}")
    (COUNTER_MMA if kernel == "mma" else COUNTER_CC).n += 1
    return out


#: key block of the meta arm's blockwise attention (the reference's)
META_BLOCK = 512

#: bytes of one float32 (rows, Sq, Sk) temporary the backward allows; it
#: holds four at once, so it works over (batch, KV head) rows in chunks
#: of at most ~1 GB of scores
BWD_CHUNK_BYTES = 1 << 28


def attention_backward(q, k, v, d_out, *, causal: bool = True, window=None,
                       scale=None):
    """Gradients (dq, dk, dv) of ``attention_ref(q, k, v)`` for the
    cotangent ``d_out``, in q's, k's and v's dtypes.

    The scores are recomputed in float32 and P is the masked softmax of
    ``attention_ref`` (a row with no live key is 0); then dV = P^T dO,
    dP = dO V^T, dS = P * (dP - rowsum(P * dP)) (rowsum(P * dP) equals
    rowsum(dO * O), O the float32 output before its cast), dQ = scale
    dS K and dK = scale dS^T Q.  A GQA group's query heads are the rows
    of one (batch, KV head) product, so dK and dV come out summed over
    the group.  Causal, window and unmasked attention share this one
    formula."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    mask = live_mask(sq, sk, causal, window, q.device)
    n = b * hkv
    qf = q.reshape(n, g * sq, d)
    kf = k.reshape(n, sk, d)
    vf = v.reshape(n, sk, d)
    dof = d_out.reshape(n, g * sq, d)
    dq = torch.empty(qf.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(kf.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(vf.shape, dtype=v.dtype, device=v.device)
    rows = max(1, BWD_CHUNK_BYTES // (g * sq * sk * 4))

    def chunk(i):
        sl = slice(i, i + rows)
        qc, kc, vc = qf[sl].float(), kf[sl].float(), vf[sl].float()
        doc = dof[sl].float()
        c = qc.shape[0]
        s = (torch.bmm(qc, kc.transpose(1, 2)) * scale).view(c, g, sq, sk)
        p = masked_softmax(s, mask).view(c, g * sq, sk)
        dv[sl] = torch.bmm(p.transpose(1, 2), doc).to(v.dtype)
        dp = torch.bmm(doc, vc.transpose(1, 2))
        ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
        dq[sl] = (torch.bmm(ds, kc) * scale).to(q.dtype)
        dk[sl] = (torch.bmm(ds.transpose(1, 2), qc) * scale).to(k.dtype)

    full = n // rows
    if q.device.type == "meta" and full > 1:
        # the meta arm: the full chunks share one shape and free their
        # temporaries before the next, so one of them, counted ``full``
        # times, stands for all (shape-only tensors compute nothing)
        with repeated(full):
            chunk(0)
        starts = range(full * rows, n, rows)
    else:
        starts = range(0, n, rows)
    for i in starts:
        chunk(i)
    return (dq.view(b, h, sq, d), dk.view(b, hkv, sk, d),
            dv.view(b, hkv, sk, d))


class FlashAttentionFn(torch.autograd.Function):
    """K2 under autograd: the forward is :func:`flash_attention` (the
    kernel's launch on the card, counted as ever; the plain version on
    the CPU), the backward :func:`attention_backward` from the saved q,
    k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, d_out, causal=ctx.causal,
                                        window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_fn(q, k, v, *, causal: bool = True, window=None,
                       scale=None) -> torch.Tensor:
    """:func:`flash_attention` with a gradient (:class:`FlashAttentionFn`)."""
    return FlashAttentionFn.apply(q, k, v, causal, window, scale)
