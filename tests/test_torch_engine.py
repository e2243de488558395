"""Port ``ServeEngine(paged=True)`` against the reference engine.

Both engines serve the same request list (more requests than lanes, a
pool small enough that admissions block on pages, varied prompt
lengths, one prompt longer than ``max_len - 1``) in lockstep: every
admission decision, every dispatch's tokens, every lane's page list and
the allocator counters must be identical, and ``pool.check()`` must hold
on both after every dispatch.  SMOKE config in float32, reference
parameters converted through numpy.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.device import DeviceUnavailable  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serving import (STATS_KEYS, AdmissionRejected,  # noqa: E402
                                 PagePool, Request, ServeEngine)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
N_LANES, MAX_LEN, PAGE, N_PAGES, DISPATCH = 3, 64, 8, 10, 4
PLENS = [5, 12, 30, 9, 70, 17, 3]          # 70 > MAX_LEN - 1: truncated
GENS = [10, 6, 12, 20, 8, 5, 9]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    return jcfg, jparams, cfg, params, prompts


def _engines(setup):
    jcfg, jparams, cfg, params, prompts = setup
    kw = dict(n_lanes=N_LANES, max_len=MAX_LEN, paged=True, page_size=PAGE,
              n_pages=N_PAGES, dispatch_n=DISPATCH)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    jreqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    return jeng, teng, jreqs, treqs


def _same_state(jeng, teng):
    for lane in range(N_LANES):
        assert teng.lane_pages(lane) == list(jeng._lane_pages[lane]), lane
    jeng.pool.check()
    teng.pool.check()
    assert teng.pool.available() == jeng.pool.available()
    assert teng.pool.hwm == jeng.pool.hwm


def test_engine_lockstep_matches_reference(setup):
    jeng, teng, jreqs, treqs = _engines(setup)
    before = launch_counts()
    pending = list(range(len(treqs)))
    n_blocked_rounds = 0
    while pending or teng.live_lanes():
        while pending and teng.free_lanes():
            i = pending[0]
            ok_t = teng.admit(treqs[i])
            assert jeng.admit(jreqs[i]) == ok_t, f"admit uid={i}"
            if not ok_t:
                n_blocked_rounds += 1
                break
            pending.pop(0)
        _same_state(jeng, teng)
        out_t = teng.decode_n(DISPATCH)
        assert jeng.decode_n(DISPATCH) == out_t
        _same_state(jeng, teng)
    assert n_blocked_rounds > 0             # the pool did gate admission
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.generated == jr.generated, tr.uid
        # the length cap (max_len - 1) stops a lane after at least one
        # token, even when the truncated prompt already reaches it
        plen = min(PLENS[tr.uid], MAX_LEN - 1)
        assert len(tr.generated) == min(GENS[tr.uid],
                                        max(MAX_LEN - 1 - plen, 1))
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["kv_admit_blocked"] > 0
    assert teng.stats["prefill_compiles"] == 4
    assert teng.pool.n_in_use == 0 and teng.pool.available() == N_PAGES
    assert launch_counts() == before        # CPU: no kernel launched


def test_run_matches_reference_run(setup):
    jeng, teng, jreqs, treqs = _engines(setup)
    jeng.run(jreqs)
    teng.run(treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    teng.pool.check()


def test_never_admissible_raises(setup):
    _, _, cfg, params, prompts = setup
    eng = ServeEngine(cfg, params, n_lanes=2, max_len=MAX_LEN, paged=True,
                      page_size=PAGE, n_pages=N_PAGES, device="cpu")
    # the worst case is clamped to max_len: an over-budget request fits
    big = Request(uid=9, prompt=prompts[4], max_new_tokens=500)
    assert eng.admission_pages(big) == MAX_LEN // PAGE
    eng.run([big])
    assert big.done and len(big.generated) == 1   # prompt filled the cap
    # pages promised elsewhere and nothing in flight to retire: refused
    assert eng.pool.reserve(N_PAGES - 2)
    with pytest.raises(AdmissionRejected, match="can never be admitted"):
        eng.run([Request(uid=10, prompt=prompts[2], max_new_tokens=8)])
    assert eng.stats["admit_rejected"] == 1


def test_engine_guards(setup):
    _, _, cfg, params, _ = setup
    # the default is the reference's: fixed-lane, greedy, seed 0
    eng = ServeEngine(cfg, params, device="cpu")
    assert not eng.paged and eng.pool is None and "k" in eng.cache
    assert eng.temperature == 0.0
    # int8 KV: int8 values plus f32 per-token scales with the trailing 1,
    # on both layouts (the scratch page included in the pools)
    cfg_q = dataclasses.replace(cfg, kv_quant="int8")
    dense = ServeEngine(cfg_q, params, n_lanes=2, max_len=MAX_LEN,
                        device="cpu").cache
    paged = ServeEngine(cfg_q, params, n_lanes=2, max_len=MAX_LEN,
                        paged=True, page_size=PAGE, n_pages=N_PAGES,
                        device="cpu").cache
    for cache, names in ((dense, ("k", "v", "k_scale", "v_scale")),
                         (paged, ("k_pages", "v_pages", "k_scale_pages",
                                  "v_scale_pages"))):
        kv_shape = cache[names[0]].shape
        assert kv_shape[1] == (2 if cache is dense else N_PAGES + 1)
        for name in names[:2]:
            assert cache[name].dtype == torch.int8
            assert cache[name].shape == kv_shape
        for name in names[2:]:
            assert cache[name].dtype == torch.float32
            assert cache[name].shape == kv_shape[:-1] + (1,)
            assert bool((cache[name] == 1).all())
    with pytest.raises(AssertionError, match="page_size"):
        ServeEngine(cfg, params, max_len=60, paged=True, page_size=16,
                    device="cpu")
    with pytest.raises(AssertionError, match="page pool smaller"):
        ServeEngine(cfg, params, max_len=MAX_LEN, paged=True,
                    page_size=PAGE, n_pages=2, device="cpu")
    with pytest.raises(ValueError, match="params on"):
        ServeEngine(cfg, LM(cfg, torch.device("meta")), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable):
            ServeEngine(cfg, params)


def test_page_pool_churn_invariants():
    rng = np.random.default_rng(0)
    pool = PagePool(32, 8)
    held = []
    for _ in range(300):
        if held and rng.random() < 0.45:
            pages, extra = held.pop(int(rng.integers(len(held))))
            pool.free(pages)
            pool.unreserve(extra)
        else:
            n = int(rng.integers(1, 6))
            if pool.reserve(n):
                k = int(rng.integers(0, n + 1))
                held.append((pool.alloc(k), n - k))
        pool.check()
        assert pool.n_free + pool.n_in_use == 32
    for pages, extra in held:
        pool.free(pages)
        pool.unreserve(extra)
    pool.check()
    assert pool.n_free == 32
    with pytest.raises(AssertionError, match="double free"):
        pool.free([0])
