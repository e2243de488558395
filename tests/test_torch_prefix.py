"""Prefix sharing over copy-on-write pages, held against the reference.

* allocator: the refcounted ``PagePool`` follows the reference's through
  a scripted mix of reserve / alloc / share / cow / free (refcounts,
  free-list order, counters), and each misuse (share of a free page,
  cow of an exclusive page, cow without a reservation, a double free)
  raises as the reference's does;
* radix cache: ``PrefixCache.match`` / ``insert`` / ``evict_lru`` /
  ``flush`` return what the reference's do, op by op, on random prompt
  families over pools of their own, and leave the pools equal;
* engine: the sharing engine in lockstep with the reference's sharing
  engine, greedy and at t=0.8, bf16-path (float32) and int8 KV: every
  admission, every decode block, every ``STATS_KEYS`` counter (all the
  ``prefix_*`` ones), each lane's page list and the cache's page count,
  with a partial page copied on write and, in its own test, the cache
  trimmed under pool pressure; the shared streams equal the unshared
  port engine's; the predicate refuses windows and recurrent state;
* launcher: ``--prefix-sharing --smoke`` prints the reference's prefix
  line.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve_launcher  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.serving import PagePool as JaxPagePool  # noqa: E402
from repro.serving import PrefixCache as JaxPrefixCache  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.serving import (STATS_KEYS, PagePool,  # noqa: E402
                                 PrefixCache, Request, ServeEngine,
                                 prefix_sharing_supported)

pytestmark = [pytest.mark.torch_port, pytest.mark.prefix]
torch.set_num_threads(2)

CPU = torch.device("cpu")
PAGE = 8
ENGINE_KW = dict(n_lanes=2, max_len=48, dispatch_n=4, paged=True,
                 page_size=PAGE, rng_seed=7)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def _pool_state(pool):
    return (list(pool._free), sorted(pool._in_use), dict(pool._refcount),
            pool._reserved, pool.hwm, pool.n_shared, pool.n_refs)


# ----------------------------------------------------------------------
# allocator
# ----------------------------------------------------------------------

def test_pagepool_follows_reference():
    """The same script on both pools leaves the same state after every
    call, and every call returns the same value."""
    ours, ref = PagePool(6, PAGE), JaxPagePool(6, PAGE)
    script = [("reserve", (4,)), ("alloc", (2,)), ("share", ([0],)),
              ("share", ([0, 1],)), ("free", ([0],)), ("cow", (0,)),
              ("alloc", (1,)), ("reserve", (9,)), ("free", ([1, 1],)),
              ("share", ([2],)), ("reserve", (1,)), ("cow", (2,)),
              ("free", ([0, 2, 3],)),
              ("reserve", (2,)), ("alloc", (2,)), ("unreserve", (0,))]
    for name, args in script:
        got = getattr(ours, name)(*args)
        want = getattr(ref, name)(*args)
        assert got == want, name
        assert _pool_state(ours) == _pool_state(ref), name
        ours.check()
        for p in range(6):
            assert ours.refcount(p) == ref.refcount(p)
            assert ours.is_shared(p) == ref.is_shared(p)


def _misuse(pool, case):
    assert pool.reserve(2)
    (p,) = pool.alloc(1)
    if case == "share_free_page":
        pool.share([p + 1])
    elif case == "cow_exclusive":
        pool.cow(p)
    elif case == "cow_without_reservation":
        pool.share([p])
        pool.unreserve(1)
        pool.cow(p)
    elif case == "double_free":
        pool.share([p])
        pool.free([p, p])
        pool.free([p])


@pytest.mark.parametrize("case", ["share_free_page", "cow_exclusive",
                                  "cow_without_reservation", "double_free"])
def test_pagepool_misuse_raises_like_reference(case):
    for pool in (JaxPagePool(4, PAGE), PagePool(4, PAGE)):
        with pytest.raises(AssertionError):
            _misuse(pool, case)


# ----------------------------------------------------------------------
# radix cache
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefix_cache_follows_reference(seed):
    """Random prompt families (a few shared heads, tails of random
    length, some prompts extending others) through a random mix of
    insert (of freshly allocated donor pages, the donor then retiring),
    match (with and without partial pages) and LRU eviction, then a
    flush: every return value and the pools equal at every step.  Odd
    seeds also trim both caches to a page budget before each insert,
    one ``evict_lru`` at a time, as the engine trims under pressure."""
    rng = np.random.default_rng(seed)
    pools = (PagePool(64, PAGE), JaxPagePool(64, PAGE))
    caches = (PrefixCache(pools[0], PAGE), JaxPrefixCache(pools[1], PAGE))
    budget = 12 if seed % 2 else None
    n_trimmed = 0
    heads = [rng.integers(0, 50, n).astype(np.int32)
             for n in rng.integers(4, 30, 3)]
    prompts = []
    for _ in range(24):
        if prompts and rng.random() < 0.25:      # extend an earlier one
            base = prompts[rng.integers(len(prompts))]
        else:
            base = heads[rng.integers(len(heads))]
        tail = rng.integers(0, 50, rng.integers(1, 12)).astype(np.int32)
        prompts.append(np.concatenate([base, tail]))
    for prompt in prompts:
        partial = bool(rng.random() < 0.7)
        got = caches[0].match(prompt, allow_partial=partial)
        want = caches[1].match(prompt, allow_partial=partial)
        assert got == want
        plen = len(prompt)
        n = -(-plen // PAGE)
        while budget is not None and caches[0].n_pages >= budget:
            assert caches[0].evict_lru() == caches[1].evict_lru() == True
            n_trimmed += 1
        if pools[0].available() >= n:
            lane_pages = []
            for pool, cache in zip(pools, caches):
                assert pool.reserve(n)
                lane_pages.append(pool.alloc(n))
            assert lane_pages[0] == lane_pages[1]
            added = [c.insert(prompt, plen, pages, allow_partial=partial)
                     for c, pages in zip(caches, lane_pages)]
            assert added[0] == added[1]
            for pool, pages in zip(pools, lane_pages):
                pool.free(pages)                 # the donor retires
        if rng.random() < 0.3:
            assert caches[0].evict_lru() == caches[1].evict_lru()
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        assert caches[0].n_pages == caches[1].n_pages
    assert (n_trimmed > 0) == (budget is not None)
    assert caches[0].flush() == caches[1].flush()
    assert _pool_state(pools[0]) == _pool_state(pools[1])
    assert pools[0].n_in_use == 0
    pools[0].check()


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------

def _family(cfg, seed=11):
    """A 20-token head (2 full pages and 4 tokens) served alone first
    (its own partial page goes to the cache), then the head extended by
    2 tokens (matches the partial page: a copy-on-write split), family
    members with tails of their own (full pages shared), an unrelated
    prompt (a miss), a family member past ``max_len - 1`` (truncated to
    its tail: a miss), and the head again (its own pages, capped at
    ``plen - 1`` tokens matched)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)

    def tail(n):
        return rng.integers(0, cfg.vocab_size, n).astype(np.int32)

    return [head, np.concatenate([head, tail(2)]),
            np.concatenate([head, tail(9)]), tail(13),
            np.concatenate([head, tail(5)]), np.concatenate([head, tail(40)]),
            head.copy(), np.concatenate([head[:16], tail(7)])]


def _lockstep(setup, prompts, gens, **kw):
    """Both sharing engines driven admission by admission and block by
    block: admissions, blocks, lane pages and the cache's size equal
    throughout, every STATS_KEYS counter at the end."""
    jcfg, jparams, cfg, params = setup
    kw = dict(ENGINE_KW, prefix_sharing=True, **kw)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    jreqs = [JaxRequest(uid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    treqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    pending = list(range(len(treqs)))
    while pending or teng.live_lanes():
        while pending and teng.free_lanes():
            i = pending[0]
            ok = teng.admit(treqs[i])
            assert jeng.admit(jreqs[i]) == ok, f"admit uid={i}"
            if not ok:
                break
            pending.pop(0)
            lane = teng.lane_req.index(treqs[i])
            assert teng.lane_pages(lane) == list(jeng._lane_pages[lane])
            assert teng.prefix_cache.n_pages == jeng.prefix_cache.n_pages
            assert _pool_state(teng.pool) == _pool_state(jeng.pool)
        assert teng.decode_n() == jeng.decode_n()
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.generated == jr.generated, tr.uid
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    return teng, treqs


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_sharing_engine_lockstep_matches_reference(setup, temperature,
                                                   kv_quant):
    jcfg, jparams, cfg, params = setup
    setup = (dataclasses.replace(jcfg, kv_quant=kv_quant), jparams,
             dataclasses.replace(cfg, kv_quant=kv_quant), params)
    prompts = _family(cfg)
    gens = [6, 5, 7, 4, 6, 3, 5, 4]
    teng, treqs = _lockstep(setup, prompts, gens, temperature=temperature)
    st = teng.stats
    assert st["prefix_hits"] >= 4 and st["prefix_misses"] >= 3
    assert st["prefix_pages_saved"] >= 8
    if kv_quant is None:
        assert st["prefix_cow_copies"] >= 1        # the extended head
        assert st["ssm_prefill_compiles"] >= 1     # the streamed tails
    else:
        assert st["prefix_cow_copies"] == 0        # full pages only
    # the same streams as the unshared engine
    base = ServeEngine(setup[2], params, device="cpu", temperature=temperature,
                       **ENGINE_KW)
    breqs = base.run([Request(uid=i, prompt=p.copy(), max_new_tokens=g)
                      for i, (p, g) in enumerate(zip(prompts, gens))])
    assert [r.generated for r in breqs] == [r.generated for r in treqs]
    assert base.stats["prefix_hits"] == 0
    teng.prefix_cache.flush()
    teng.pool.check()
    assert teng.pool.n_in_use == 0


def test_sharing_engine_trims_cache_like_reference(setup):
    """Six unrelated prompts through a pool of 8 pages: admission trims
    the cache (LRU leaves) instead of blocking for good, as the
    reference's does, and nothing leaks."""
    _, _, cfg, _ = setup
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
               for _ in range(6)]
    teng, treqs = _lockstep(setup, prompts, [4] * 6, n_pages=8)
    assert all(len(r.generated) == 4 for r in treqs)
    assert teng.stats["prefix_evictions"] > 0
    assert teng.stats["kv_pages_hwm"] <= 8
    teng.prefix_cache.flush()
    teng.pool.check()
    assert teng.pool.n_in_use == 0


def test_cow_leaves_the_donor_page_and_copies_it(setup):
    """A lane admitted over a shared partial page gets a fresh page
    holding the donor page's bytes; the donor's page and its refcount
    (the cache's and the donor's) stay."""
    _, _, cfg, params = setup
    prompts = _family(cfg)
    eng = ServeEngine(cfg, params, device="cpu", prefix_sharing=True,
                      **ENGINE_KW)
    donor = Request(uid=0, prompt=prompts[0].copy(), max_new_tokens=20)
    assert eng.admit(donor)
    old = eng.lane_pages(0)[2]                     # the partial page
    assert eng.pool.refcount(old) == 2             # donor + cache
    ext = Request(uid=1, prompt=prompts[1].copy(), max_new_tokens=4)
    assert eng.admit(ext)
    new = eng.lane_pages(1)[2]
    assert new != old and eng.pool.refcount(old) == 2
    assert eng.lane_pages(1)[:2] == eng.lane_pages(0)[:2]
    assert int(eng.cache["block_tables"][1, 2]) == new
    pool = eng.cache["k_pages"]
    # the copy holds the donor's 4 head tokens; the tail streamed after
    assert torch.equal(pool[:, new, :, :4], pool[:, old, :, :4])
    assert eng.stats["prefix_cow_copies"] == 1


def test_prefix_sharing_supported_predicate(setup):
    _, _, cfg, params = setup
    assert prefix_sharing_supported(cfg)
    for other in (dataclasses.replace(cfg, sliding_window=16),
                  get_config("mamba2-780m", smoke=True),
                  get_config("hymba-1.5b", smoke=True)):
        assert not prefix_sharing_supported(other)
    with pytest.raises(AssertionError):
        ServeEngine(dataclasses.replace(cfg, sliding_window=16), params,
                    prefix_sharing=True, device="cpu", **ENGINE_KW)
    fixed = ServeEngine(cfg, params, n_lanes=2, max_len=48,
                        prefix_sharing=True, device="cpu")
    assert fixed.prefix_cache is None              # as the reference


def test_launcher_prints_the_reference_prefix_line(capsys):
    argv = ["--arch", "qwen2.5-1.5b", "--smoke", "--prefix-sharing",
            "--requests", "5", "--prompt-len", "40", "--gen", "4",
            "--lanes", "2", "--page-size", "8"]
    jax_serve_launcher.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("prefix sharing:")]
    serve_launcher.main(argv + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("prefix sharing:")]
    assert len(want) == 1 and got == want
    assert "4 hits" in want[0]
