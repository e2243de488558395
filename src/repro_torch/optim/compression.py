"""int8 error-feedback gradient compression: the reference's
``optim/compression.py``.

Per-chunk absmax int8 quantization, a sum of the dequantized chunks
over the participants, and an error-feedback residual carried between
steps so that the compression bias vanishes over time.  The reference
sums over a named mesh axis inside ``shard_map``; here the participants
are a ``torch.distributed`` process group -- a mesh axis's,
``mesh.get_group("pod")`` -- each quantizing its own ``x``, and with none
the reduction is over one participant: the mean is the local
dequantized chunks and the residual ``x`` minus them, what the
reference's returns over an axis of size 1.

Usage::

    g_hat, resid = compressed_psum(g + resid_prev,
                                   group=mesh.get_group("pod"))
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.quant.quantize import true_div

CHUNK = 2048


def _quantize_chunks(x: torch.Tensor, chunk: int):
    """(q int8 (n_chunks, chunk), scale float32 (n_chunks, 1), n, pad) of
    a float32 tensor: ``scale = max|chunk| / 127`` (1 where 0), ``q =
    clip(round(x / scale), -127, 127)``."""
    n = x.numel()
    pad = (-n) % chunk
    flat = torch.nn.functional.pad(x.reshape(-1), (0, pad)).reshape(-1, chunk)
    scale = true_div(torch.amax(torch.abs(flat), dim=1, keepdim=True), 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale, n, pad


def compressed_psum(x: torch.Tensor, group=None, chunk: int = CHUNK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce over ``group`` (a ``torch.distributed`` process
    group; ``None`` is one participant); returns (mean, residual error),
    both in x's dtype."""
    q, scale, n, _ = _quantize_chunks(x.to(torch.float32), chunk)
    # each participant contributes its locally quantized values; the sum
    # happens in float32 after the dequantize (scales differ per
    # participant)
    local = q.to(torch.float32) * scale
    total = local
    size: Optional[int] = None
    if group is not None:
        import torch.distributed as dist
        staged = local.is_cuda and dist.get_backend(group) == "gloo"
        total = local.to("cpu", copy=True) if staged else local.clone()
        dist.all_reduce(total, group=group)
        total = total.to(local.device)
        size = dist.get_world_size(group)
    mean = total if size is None else true_div(total, float(size))
    mean = mean.reshape(-1)[:n].reshape(x.shape)
    resid = x.to(torch.float32) - local.reshape(-1)[:n].reshape(x.shape)
    return mean.to(x.dtype), resid.to(x.dtype)


def compress_roundtrip_error(x: torch.Tensor, chunk: int = CHUNK) -> float:
    """Relative RMS error of one quantize/dequantize pass (tests)."""
    q, scale, n, _ = _quantize_chunks(x.to(torch.float32), chunk)
    back = (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(x.shape)
    num = torch.sqrt(torch.mean((x - back) ** 2))
    den = torch.sqrt(torch.mean(x ** 2)) + 1e-12
    return float(num / den)
