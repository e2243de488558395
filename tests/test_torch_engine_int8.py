"""Port ``ServeEngine`` with an int8 KV cache (``kv_quant="int8"``)
against the reference.

Both engines serve the same request list (more requests than lanes,
varied prompt lengths, one prompt longer than ``max_len - 1``) in
lockstep on both layouts, greedy and at ``temperature=0.8``: every
admission, every ``decode_n`` block and every ``STATS_KEYS`` counter
must be identical, and the port's two layouts must give identical
streams.  The prompt KV is quantized bitwise as the reference quantizes
it, on the same input.  SMOKE config in float32, reference parameters
converted through numpy; token streams are compared exactly.  Last, the
reference's ``test_int8_kv_tracks_dense`` on the port: the int8 cache
tracks the bf16 cache in log-prob space.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import (init_cache,  # noqa: E402
                                            lm_decode_step)
from repro_torch.serving import STATS_KEYS, Request, ServeEngine  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
N_LANES, MAX_LEN, PAGE, N_PAGES, DISPATCH = 3, 64, 8, 12, 4
PLENS = [5, 12, 30, 9, 70, 17, 3]          # 70 > MAX_LEN - 1: truncated
GENS = [10, 6, 12, 20, 8, 5, 9]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32", kv_quant="int8")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32", kv_quant="int8")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    return jcfg, jparams, cfg, params, prompts


def _requests(prompts, cls):
    return [cls(uid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, GENS))]


def _lockstep(setup, **kw):
    """Drive both engines admission by admission and block by block."""
    jcfg, jparams, cfg, params, prompts = setup
    kw = dict(n_lanes=N_LANES, max_len=MAX_LEN, dispatch_n=DISPATCH, **kw)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    jreqs, treqs = _requests(prompts, JaxRequest), _requests(prompts,
                                                             Request)
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
        if teng.paged:
            teng.pool.check()
            for lane in range(N_LANES):
                assert teng.lane_pages(lane) == list(jeng._lane_pages[lane])
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.generated == jr.generated, tr.uid
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    return teng, treqs


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_int8_lockstep_matches_reference(setup, paged, temperature):
    before = launch_counts()
    kw = dict(paged=True, page_size=PAGE, n_pages=N_PAGES) if paged else {}
    teng, _ = _lockstep(setup, temperature=temperature, rng_seed=5, **kw)
    assert teng.cache["k_pages" if paged else "k"].dtype == torch.int8
    assert launch_counts() == before        # CPU: no kernel launched


def test_int8_layouts_identical(setup):
    """The layout does not show in any int8 stream, greedy or sampled."""
    _, _, cfg, params, prompts = setup
    for temperature in (0.0, 0.8):
        streams = []
        for kw in (dict(paged=False), dict(paged=True, page_size=PAGE)):
            eng = ServeEngine(cfg, params, n_lanes=N_LANES, max_len=MAX_LEN,
                              temperature=temperature, rng_seed=2,
                              dispatch_n=DISPATCH, device="cpu", **kw)
            streams.append([r.generated for r in
                            eng.run(_requests(prompts, Request))])
        assert streams[0] == streams[1], temperature


def _prompt_kv(plen_bucket, seed=0):
    """One prefill's (k, v), each (L, 1, Hkv, S_bucket, D), as numpy."""
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, plen_bucket, cfg.hd)
    return [(2.0 * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("plen,smax", [(5, 64), (30, 64), (40, 32)])
def test_int8_prompt_kv_bitwise_matches_reference(setup, plen, smax):
    """``_prompt_kv_views`` on one same prefill KV: the int8 values and
    f32 scales equal the reference's bit for bit, ring-rolled when the
    prompt wraps the cache (40 > 32)."""
    jcfg, jparams, cfg, params, _ = setup
    jeng = JaxServeEngine(jcfg, jparams, n_lanes=1, max_len=MAX_LEN)
    teng = ServeEngine(cfg, params, n_lanes=1, max_len=MAX_LEN, device="cpu")
    k, v = _prompt_kv(64)
    jent, jtake = jeng._prompt_kv_views((jnp.asarray(k), jnp.asarray(v)),
                                        plen, smax)
    tent, ttake = teng._prompt_kv_views((torch.from_numpy(k),
                                         torch.from_numpy(v)), plen, smax)
    assert ttake == jtake == min(plen, smax)
    assert sorted(tent) == sorted(jent) == ["k", "k_scale", "v", "v_scale"]
    for key in jent:
        assert tent[key].dtype == (torch.int8 if key in ("k", "v")
                                   else torch.float32)
        assert np.array_equal(tent[key].numpy(), np.asarray(jent[key])), key


@pytest.mark.parametrize("paged", [False, True])
def test_int8_prompt_scatter_matches_reference(setup, paged):
    """The scatter writes all four entries of the lane (values and
    scales, pages in the lane's order, the last page padded) exactly as
    the reference does, from one same prefill KV."""
    jcfg, jparams, cfg, params, _ = setup
    kw = dict(n_lanes=2, max_len=MAX_LEN)
    if paged:
        kw.update(paged=True, page_size=PAGE, n_pages=N_PAGES)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    k, v = _prompt_kv(32, seed=1)
    plen, lane = 21, 1
    if paged:
        jeng._lane_pages[lane] = [7, 2, 9]
        teng._lane_pages[lane] = [7, 2, 9]
        jeng._scatter_prompt_paged((jnp.asarray(k), jnp.asarray(v)), lane,
                                   plen)
        teng._scatter_prompt_paged((torch.from_numpy(k),
                                    torch.from_numpy(v)), lane, plen)
        keys = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
    else:
        jeng._scatter_prompt_dense((jnp.asarray(k), jnp.asarray(v)), lane,
                                   plen)
        teng._scatter_prompt_dense((torch.from_numpy(k),
                                    torch.from_numpy(v)), lane, plen)
        keys = ("k", "v", "k_scale", "v_scale")
    for key in keys:
        assert teng.cache[key].dtype == (torch.float32 if "scale" in key
                                         else torch.int8)
        assert np.array_equal(teng.cache[key].numpy(),
                              np.asarray(jeng.cache[key])), key


def test_int8_kv_tracks_dense():
    """The reference's ``test_int8_kv_tracks_dense`` on the port (SMOKE,
    bf16, seeded port weights): 16 decode steps on an int8 cache stay
    within 0.15 in log-prob of the bf16 cache and agree on the top-1."""
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    cfg_q = dataclasses.replace(cfg, kv_quant="int8")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))

    def run(c):
        cache = init_cache(c, 2, 24, device=CPU)
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = lm_decode_step(params, c, cache, tokens[:, t])
        return torch.log_softmax(logits[:, :cfg.vocab_size].float(), dim=-1)

    dense = run(cfg)
    quant = run(cfg_q)
    assert float((dense - quant).abs().max()) < 0.15
    assert torch.equal(dense.argmax(-1), quant.argmax(-1))
