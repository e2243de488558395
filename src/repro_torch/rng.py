"""threefry2x32 random numbers, bit-compatible with ``jax.random``.

Reproduces the installed reference defaults: the ``threefry2x32``
key implementation with ``jax_threefry_partitionable=True`` and 64-bit
mode off.  A key is an int64 tensor of shape ``(..., 2)`` whose last
axis holds the two uint32 words; leading axes batch independent keys
(the reference ``vmap``s over lanes).  PyTorch has no unsigned 32-bit
arithmetic on every backend, so each 32-bit word rides in an int64
tensor and is masked back to 32 bits after every add and shift.

Counter layout (partitionable mode): element ``i`` of a flat draw of
shape ``shape`` hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)``
and returns ``bits1 ^ bits2``, so a draw of shape ``(1, V)`` gives the
same bits as one of shape ``(V,)``.

Everything runs on the device of the key; nothing syncs with the host,
and no Python number becomes a host tensor copied to the device (the
decode dispatch runs inside a CUDA graph on the card).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

__all__ = ["PRNGKey", "categorical", "fold_in", "gumbel", "random_bits",
           "threefry2x32", "uniform"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: ``np.finfo(np.float32).tiny``: the low end of the Gumbel uniform
_F32_TINY = 1.1754943508222875e-38
_ONE_BITS = 0x3F800000              # float32 1.0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counters ``(x0, x1)`` under
    key ``(k0, k1)``; all int64 holding uint32 values, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: with 64-bit mode off the seed is
    taken modulo 2**32 and the key is ``(0, seed)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor,
            data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)`` under
    ``key``.  ``key`` (..., 2) and ``data`` (...) broadcast, so a tensor
    of per-lane data folds every lane at once."""
    if not isinstance(data, torch.Tensor):    # a fill, not a host copy
        data = torch.full((), int(data), dtype=torch.int64,
                          device=key.device)
    data = data.to(torch.int64) & MASK
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack((b0, b1), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` as int64 uint32 values, shape
    ``key.shape[:-1] + shape`` (one independent draw per leading key)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 1 << 32:
        raise ValueError(f"draw of {n} elements exceeds 2**32 counters")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    batch = key.shape[:-1]
    expand = (...,) + (None,) * len(shape)
    k0 = key[..., 0][expand]
    k1 = key[..., 1][expand]
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return (b0 ^ b1).expand(batch + shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), shifted to [0, 1), then scaled to
    ``[minval, maxval)`` and clamped below at ``minval``.

    The reference's compiler contracts ``f * (hi - lo) + lo`` into one
    fused multiply-add; the product of two float32 values is exact in
    float64, so the sum is taken there and rounded once to float32."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (default "low" mode), float32."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` by the Gumbel-max
    trick: ``argmax(gumbel + logits)``, int64.  A key with leading axes
    samples each row of ``logits`` under its own key; an unbatched key
    draws noise of ``logits.shape``."""
    noise_shape = logits.shape[key.dim() - 1:]
    g = gumbel(key, noise_shape)
    return torch.argmax(g + logits, dim=-1)
