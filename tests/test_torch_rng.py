"""The port's threefry random numbers against ``jax.random``.

Keys, ``fold_in``, raw bits and ``uniform`` must be bitwise equal to the
reference's for several seeds, data values and shapes (threefry2x32,
partitionable counters, 64-bit mode off).  ``gumbel`` goes through
``log``, whose last bit differs between the two libraries, so it is
held at 1 ulp-scale tolerance (1e-6 absolute on values of order 1-20)
and ``categorical`` must draw the same indices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import rng  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

SEEDS = [0, 1, 42, 2**31 - 1, 2**32 + 5, -7]
SHAPES = [(5,), (1, 512), (512,), (3, 7, 2), (1, 151936)]


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bitwise(seed):
    jkey = jax.random.PRNGKey(seed)
    key = rng.PRNGKey(seed)
    assert np.array_equal(key.numpy(), _words(jkey))
    for data in (0, 1, 5, 2**31 + 3, 2**32 - 1):
        assert np.array_equal(rng.fold_in(key, data).numpy(),
                              _words(jax.random.fold_in(jkey, data))), data
    # batched over lanes, as the engine folds lane seeds and token indices
    lanes = np.array([0, 3, 9, 1000], np.int32)
    jl = jax.vmap(lambda s: jax.random.fold_in(jkey, s))(jnp.asarray(lanes))
    tl = rng.fold_in(key, torch.from_numpy(lanes))
    assert np.array_equal(tl.numpy(), _words(jl))
    idx = np.array([4, 0, 7, 2], np.int32)
    jk = jax.vmap(jax.random.fold_in)(jl, jnp.asarray(idx))
    assert np.array_equal(rng.fold_in(tl, torch.from_numpy(idx)).numpy(),
                          _words(jk))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 42, 2**32 + 5])
def test_bits_and_uniform_bitwise(seed, shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    key = rng.fold_in(rng.PRNGKey(seed), 3)
    assert np.array_equal(rng.random_bits(key, shape).numpy(),
                          _words(jax.random.bits(jkey, shape)))
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.5, 3.3)):
        ref = np.asarray(jax.random.uniform(jkey, shape, minval=lo,
                                            maxval=hi))
        out = rng.uniform(key, shape, lo, hi).numpy()
        assert out.dtype == np.float32
        assert np.array_equal(out.view(np.int32), ref.view(np.int32)), \
            (lo, hi)


def test_uniform_shape_1v_equals_v():
    key = rng.PRNGKey(11)
    a = rng.uniform(key, (1, 1000)).numpy()[0]
    b = rng.uniform(key, (1000,)).numpy()
    assert np.array_equal(a, b)


def test_gumbel_close_to_reference():
    jkey, key = jax.random.PRNGKey(5), rng.PRNGKey(5)
    ref = np.asarray(jax.random.gumbel(jkey, (4096,)))
    out = rng.gumbel(key, (4096,)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_categorical_draws_match_over_keys():
    logits = np.random.default_rng(0).standard_normal((300, 512)
                                                      ).astype(np.float32)
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(1), s)
                     )(jnp.arange(300))
    keys = rng.fold_in(rng.PRNGKey(1), torch.arange(300))
    ref = np.asarray(jax.vmap(
        lambda k, l: jax.random.categorical(k, l / 0.8))(
            jkeys, jnp.asarray(logits)))
    out = rng.categorical(keys, torch.from_numpy(logits) / 0.8).numpy()
    assert np.array_equal(out, ref)
    # one key over a (1, V) row, as the engine samples a first token
    for s in range(20):
        jk, tk = jax.random.PRNGKey(s), rng.PRNGKey(s)
        ref1 = np.asarray(jax.random.categorical(jk, jnp.asarray(logits[:1])))
        out1 = rng.categorical(tk, torch.from_numpy(logits[:1])).numpy()
        assert np.array_equal(out1, ref1), s


def test_sample_tokens_match_reference():
    """The model's samplers (per-batch and per-lane keys) against the
    reference's, greedy and at temperature 0.8, on (B, V) logits."""
    from repro.models.transformer import sample_tokens as jax_sample
    from repro.models.transformer import \
        sample_tokens_lanes as jax_sample_lanes
    from repro_torch.models.transformer import (sample_tokens,
                                                sample_tokens_lanes)
    logits = np.random.default_rng(2).standard_normal((8, 1024)
                                                      ).astype(np.float32)
    tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
    for t in (0.0, 0.8):
        for s in range(10):
            jk, tk = jax.random.PRNGKey(s), rng.PRNGKey(s)
            assert np.array_equal(sample_tokens(tl, tk, t).numpy(),
                                  np.asarray(jax_sample(jl, jk, t)))
            lanes = np.arange(8, dtype=np.int32) + 10 * s
            jkeys = jax.vmap(lambda d: jax.random.fold_in(jk, d))(
                jnp.asarray(lanes))
            tkeys = rng.fold_in(tk, torch.from_numpy(lanes))
            assert np.array_equal(
                sample_tokens_lanes(tl, tkeys, t).numpy(),
                np.asarray(jax_sample_lanes(jl, jkeys, t))), (t, s)
