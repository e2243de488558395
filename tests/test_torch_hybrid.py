"""Port hybrid model (hymba SMOKE: attention with a sliding window of 32
beside Mamba-2 heads in every block) against the JAX reference.

Parameters come from the reference's ``init_lm`` on the SMOKE config in
float32, brought to numpy and converted with ``params_from_jax``; the
same token arrays go to both sides.  Tolerance 1e-4 on logits and KV
(float32, sums in another order), as ``tests/test_torch_model.py``.
Prompts and decode runs go past the window, so the ring (dense) and the
window's fixed page set (paged, shuffled tables) both wrap; the paged
logits must equal the dense ones bit for bit, as the reference's
``test_window_rotation_in_block_table`` requires of its own.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    init_cache as jax_init_cache, init_lm as jax_init_lm,
    init_paged_cache as jax_init_paged_cache, lm_decode_step as
    jax_lm_decode_step, lm_forward as jax_lm_forward,
    lm_prefill_batched as jax_lm_prefill_batched)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_cache, init_paged_cache, lm_decode_step, lm_forward,
    lm_prefill_batched)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("hymba-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def test_config_is_the_reference_config():
    for smoke in (False, True):
        ref = jax_get_config("hymba-1.5b", smoke=smoke)
        ours = get_config("hymba-1.5b", smoke=smoke)
        for field in dataclasses.fields(ours):
            want = getattr(ref, field.name)
            got = getattr(ours, field.name)
            if field.name == "ssm":
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, field.name
    cfg = get_config("hymba-1.5b")
    assert cfg.has_ssm and not cfg.attn_free
    assert build_model(cfg).cfg is cfg


def test_convert_takes_every_leaf(models):
    """Every reference leaf lands in exactly one port parameter, with its
    values: the counts match and each layer's slice is equal."""
    jcfg, jparams, cfg, params = models
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert sum(p.numel() for p in params.parameters()) == \
        sum(int(np.prod(x.shape)) for _, x in leaves)
    named = dict(params.named_parameters())
    taken = 0
    for path, leaf in leaves:
        keys = [k.key for k in path]
        arr = np.asarray(leaf)
        if keys[0] == "blocks":
            for i in range(cfg.n_layers):
                name = ".".join(["blocks", str(i)] + keys[1:])
                np.testing.assert_array_equal(named[name].numpy(), arr[i])
                taken += 1
        else:
            np.testing.assert_array_equal(named[".".join(keys)].numpy(),
                                          arr)
            taken += 1
    assert taken == len(named)
    blk = params.blocks[0]
    assert sorted(n for n, _ in blk.named_children()) == \
        ["attn", "mlp", "norm1", "norm2", "ssm"]


def test_forward_logits_match(models):
    jcfg, jparams, cfg, params = models
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 2 * cfg.sliding_window - 3)).astype(np.int32)
    jl, _ = jax_lm_forward(jparams, jnp.asarray(toks), jcfg)
    before = launch_counts()
    logits = lm_forward(params, torch.from_numpy(toks), cfg)
    assert launch_counts() == before          # CPU: plain versions
    assert logits.shape == jl.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL,
                               rtol=0)


def test_prefill_logits_and_kv_match(models):
    """A prompt longer than the window: K2 runs windowed, and the prefill
    returns the whole prompt's KV, as the reference's does."""
    jcfg, jparams, cfg, params = models
    n = cfg.sliding_window + 16
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, n)
                                             ).astype(np.int32)
    last = np.array([n - 1, cfg.sliding_window + 3], np.int32)
    jl, (jk, jv) = jax_lm_prefill_batched(jparams, jnp.asarray(toks), jcfg,
                                          last_pos=jnp.asarray(last))
    logits, (k, v) = lm_prefill_batched(params, torch.from_numpy(toks), cfg,
                                        last_pos=torch.from_numpy(last))
    assert k.shape == jk.shape == (cfg.n_layers, 2, cfg.n_kv_heads, n,
                                   cfg.hd)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=0)


def _shuffled_tables(b, t, n_pages, seed):
    perm = np.random.default_rng(seed).permutation(n_pages)[:b * t]
    return perm.reshape(b, t).astype(np.int32)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_decode_past_window_dense_and_paged(models, kv_quant):
    """Decode steps past the window: the port's dense ring and its paged
    cache (the window's fixed page set, tables shuffled) each match the
    reference's cache of the same layout within TOL at every step, the
    paged logits equal the dense ones bit for bit, and the caches end
    equal (the ring slots, the SSM state, the lengths)."""
    jcfg, jparams, cfg, params = models
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    b, ps = 2, 8
    n = cfg.sliding_window + 10
    max_len = n + 6
    jdense = jax_init_cache(jcfg, b, max_len)
    jpaged = jax_init_paged_cache(jcfg, b, max_len, page_size=ps)
    t_w = jpaged["block_tables"].shape[1]
    assert t_w == cfg.sliding_window // ps           # the fixed page set
    bt = _shuffled_tables(b, t_w, b * t_w, seed=1)
    jpaged["block_tables"] = jnp.asarray(bt)
    dense = init_cache(cfg, b, max_len, device=CPU)
    paged = init_paged_cache(cfg, b, max_len, page_size=ps, device=CPU)
    paged["block_tables"] = torch.from_numpy(bt)
    assert sorted(dense) == sorted(jdense)
    assert sorted(paged) == sorted(jpaged)
    for key in jdense:
        assert tuple(dense[key].shape) == jdense[key].shape, key
    step = jax.jit(lambda c, t: jax_lm_decode_step(jparams, jcfg, c, t))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, n)
                                             ).astype(np.int32)
    for i in range(n):
        jt, tt = jnp.asarray(toks[:, i]), torch.from_numpy(toks[:, i])
        jl_d, jdense = step(jdense, jt)
        jl_p, jpaged = step(jpaged, jt)
        ld, dense = lm_decode_step(params, cfg, dense, tt)
        lp, paged = lm_decode_step(params, cfg, paged, tt)
        np.testing.assert_allclose(ld.numpy(), np.asarray(jl_d), atol=TOL,
                                   rtol=0, err_msg=f"dense step {i}")
        np.testing.assert_allclose(lp.numpy(), np.asarray(jl_p), atol=TOL,
                                   rtol=0, err_msg=f"paged step {i}")
        assert torch.equal(ld, lp), f"paged != dense at step {i}"
    for key in ("ssm_h", "ssm_conv", "len"):
        assert torch.equal(dense[key], paged[key]), key
        np.testing.assert_allclose(dense[key].numpy(),
                                   np.asarray(jdense[key]), atol=TOL,
                                   rtol=0, err_msg=key)
    for key in ("k", "v") + (("k_scale", "v_scale") if kv_quant else ()):
        pool = paged[key + "_pages"]
        gathered = pool[:, torch.from_numpy(bt).long()]   # (L,B,T,Hkv,ps,.)
        gathered = gathered.permute(0, 1, 3, 2, 4, 5).reshape(
            dense[key].shape)
        assert torch.equal(gathered, dense[key]), key
