"""The vlm family against the reference: phi-3-vision-4.2b (the phi3-mini
backbone with a stub vision frontend whose precomputed embeddings take
the first ``n_vision_tokens`` positions) at SMOKE width in float32.

* the config copies the reference's; at full width its head dim is 96,
  which runs K2's CUDA-core kernel in bf16;
* ``lm_forward`` and ``Model.forward`` with ``vision_embeds`` within
  1e-5 of the reference's ``lm_forward`` (and different from the
  logits without them), ``lm_prefill_batched`` with them too;
* the engine, which serves the text decoder with no vision input (as
  the reference's), token-exact against the reference's on both
  layouts, greedy and at t=0.8.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.models.transformer import lm_forward as jax_lm_forward  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    lm_prefill_batched as jax_lm_prefill_batched)
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention.ops import kernel_for  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    lm_forward, lm_prefill_batched)
from repro_torch.serving import (STATS_KEYS, Request,  # noqa: E402
                                 ServeEngine)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 1e-5
ARCH = "phi-3-vision-4.2b"


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    vis = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)
                              ).astype(np.float32)
    return toks, vis


def test_config_copies_the_reference():
    for smoke in (False, True):
        cfg = get_config(ARCH, smoke=smoke)
        jcfg = jax_get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    full = get_config(ARCH)
    assert (full.family, full.n_vision_tokens, full.hd) == ("vlm", 256, 96)
    assert kernel_for(torch.bfloat16, full.hd) == "mma"


def test_forward_with_vision_embeds_matches_reference(model):
    jcfg, jparams, cfg, params = model
    toks, vis = _inputs(cfg, 2, 24, seed=1)
    want, _ = jax_lm_forward(jparams, jnp.asarray(toks), jcfg,
                             vision_embeds=jnp.asarray(vis))
    got = lm_forward(params, torch.from_numpy(toks), cfg,
                     vision_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    via_model = build_model(cfg).forward(params, torch.from_numpy(toks),
                                         vision_embeds=torch.from_numpy(vis))
    assert torch.equal(via_model, got)
    plain = lm_forward(params, torch.from_numpy(toks), cfg)
    n = cfg.n_vision_tokens
    assert not torch.allclose(plain[:, :n], got[:, :n])
    no_vis, _ = jax_lm_forward(jparams, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(plain.numpy(), np.asarray(no_vis), atol=TOL,
                               rtol=0)


def test_prefill_with_vision_embeds_matches_reference(model):
    jcfg, jparams, cfg, params = model
    toks, vis = _inputs(cfg, 2, 16, seed=2)
    last = np.array([15, 11], np.int32)
    jl, (jk, jv) = jax_lm_prefill_batched(
        jparams, jnp.asarray(toks), jcfg, vision_embeds=jnp.asarray(vis),
        last_pos=jnp.asarray(last))
    logits, (k, v) = lm_prefill_batched(
        params, torch.from_numpy(toks), cfg, last_pos=torch.from_numpy(last),
        vision_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=0)


N_LANES, MAX_LEN, PAGE, DISPATCH = 2, 48, 8, 4
PLENS = [5, 20, 9, 60, 13]                 # 60 > MAX_LEN - 1: truncated
GENS = [8, 5, 10, 6, 7]


@pytest.mark.parametrize("paged,temperature", [
    (False, 0.0), (True, 0.0), (False, 0.8)])
def test_engine_lockstep_matches_reference(model, paged, temperature):
    """Admission by admission and block by block: every admission, every
    ``decode_n`` block and every ``STATS_KEYS`` counter equal."""
    jcfg, jparams, cfg, params = model
    kw = dict(n_lanes=N_LANES, max_len=MAX_LEN, dispatch_n=DISPATCH,
              temperature=temperature, rng_seed=4)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    jreqs = [JaxRequest(uid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    treqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    pending = list(range(len(treqs)))
    while pending or teng.live_lanes():
        while pending and teng.free_lanes():
            i = pending[0]
            ok = teng.admit(treqs[i])
            assert jeng.admit(jreqs[i]) == ok, f"admit uid={i}"
            if not ok:
                break
            pending.pop(0)
        assert teng.decode_n(DISPATCH) == jeng.decode_n(DISPATCH)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.generated == jr.generated, tr.uid
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    if paged:
        teng.pool.check()
        assert teng.pool.n_in_use == 0
