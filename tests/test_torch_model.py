"""Port model (prefill + paged decode) against the JAX reference.

Parameters come from the reference's ``init_lm`` on the SMOKE config in
float32, brought to numpy and converted with ``params_from_jax``; the
same token arrays go to both sides.  Tolerance 1e-4 on logits and KV
(float32, sums in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    init_lm as jax_init_lm, init_paged_cache as jax_init_paged_cache,
    lm_decode_step as jax_lm_decode_step,
    lm_prefill_batched as jax_lm_prefill_batched)
from repro_torch import rng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_paged_cache, lm_decode_n_steps, lm_decode_step, lm_prefill_batched)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def test_convert_unstacks_every_leaf(models):
    jcfg, jparams, cfg, params = models
    n_ref = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_ref
    np.testing.assert_array_equal(
        params.blocks[1].attn.wq.numpy(),
        np.asarray(jparams["blocks"]["attn"]["wq"][1]))


def test_prefill_logits_and_kv_match(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    last = np.array([15, 9], np.int32)
    jl, (jk, jv) = jax_lm_prefill_batched(jparams, jnp.asarray(toks), jcfg,
                                          last_pos=jnp.asarray(last))
    before = launch_counts()
    logits, (k, v) = lm_prefill_batched(params, torch.from_numpy(toks), cfg,
                                        last_pos=torch.from_numpy(last))
    assert launch_counts() == before
    assert k.shape == jk.shape and logits.shape == jl.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=0)


def _shuffled_tables(b, t, n_pages, seed):
    perm = np.random.default_rng(seed).permutation(n_pages)[:b * t]
    return perm.reshape(b, t).astype(np.int32)


def test_paged_decode_steps_greedy_exact(models):
    jcfg, jparams, cfg, params = models
    b, max_len, ps = 3, 32, 8
    jcache = jax_init_paged_cache(jcfg, b, max_len, page_size=ps)
    t_w = jcache["block_tables"].shape[1]
    bt = _shuffled_tables(b, t_w, b * t_w, seed=1)
    jcache["block_tables"] = jnp.asarray(bt)
    cache = init_paged_cache(cfg, b, max_len, page_size=ps, device=CPU)
    cache["block_tables"] = torch.from_numpy(bt)
    step = jax.jit(lambda c, t: jax_lm_decode_step(jparams, jcfg, c, t))
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, b
                                            ).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for i in range(16):
        jl, jcache = step(jcache, jtok)
        tl, cache = lm_decode_step(params, cfg, cache, ttok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0, err_msg=f"step {i}")
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1).to(torch.int32)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), f"step {i}"
    np.testing.assert_allclose(cache["k_pages"].numpy(),
                               np.asarray(jcache["k_pages"]), atol=TOL,
                               rtol=0)
    assert np.array_equal(cache["len"].numpy(), np.asarray(jcache["len"]))


def test_decode_n_steps_budget_semantics(models):
    """Exhausted lanes freeze their length, stop their token index and
    flag their samples invalid; ``len_cap`` zeroes the budget."""
    _, _, cfg, params = models
    b, max_len, ps = 3, 16, 8
    cache = init_paged_cache(cfg, b, max_len, page_size=ps, device=CPU)
    cache["block_tables"] = torch.from_numpy(
        _shuffled_tables(b, max_len // ps, b * max_len // ps, seed=3))
    cache["len"] = torch.tensor([0, 5, 10], dtype=torch.int32)
    rem = torch.tensor([0, 2, 8], dtype=torch.int32)
    key = rng.PRNGKey(0)
    seeds = torch.arange(b, dtype=torch.int32)
    toks, valid, _, cache, rem, idx = lm_decode_n_steps(
        params, cfg, cache, torch.zeros(b, dtype=torch.int32), key, rem,
        seeds, torch.zeros(b, dtype=torch.int32), n_steps=6,
        len_cap=max_len - 1)
    assert valid.sum(0).tolist() == [0, 2, 5]
    assert cache["len"].tolist() == [0, 7, 15]
    assert idx.tolist() == [0, 2, 5] and rem.tolist() == [0, 0, 0]
    assert toks.shape == (6, b)
    # temperature sampling: a pure function of (key, lane seed, tok idx)
    cache["len"] = torch.tensor([3, 5, 7], dtype=torch.int32)
    draws = []
    for _ in range(2):
        c = {k: v.clone() for k, v in cache.items()}
        budget = torch.full((b,), 4, dtype=torch.int32)
        t, _, _, _, _, _ = lm_decode_n_steps(
            params, cfg, c, toks[0], key, budget, seeds,
            torch.zeros(b, dtype=torch.int32), n_steps=4, temperature=0.7)
        draws.append(t)
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < cfg.vocab_size
