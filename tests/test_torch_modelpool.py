"""Multi-model serving on one byte budget (the port's ``ModelPool`` and
``MultiModelServeEngine``) against the reference's.

On float32 SMOKE qwen2.5-1.5b and olmo-1b, the reference's weights
carried over:

* two models interleaved on one board give each model's solo
  single-engine streams, greedy and at t=0.9, KV in float32 and int8,
  and the reference's multi-model streams, with the reference's swaps,
  swap bytes and seconds, evictions, shrinks and grows; so does a
  budget tight enough to force shrinks and LRU weight evictions, and an
  unload/reload round trip (the admission counter survives it);
* a model serving live lanes is pinned; loading a second model shrinks
  the first pool's free pages by the reference's count and unloading
  grows them back; a model larger than the board is refused;
* ``PagePool.shrink``/``grow`` respect reservations, and a seeded churn
  of every pool operation leaves the port's pool in the reference's
  state op for op; the page sanitizer follows shrinks and grows;
* ``kv_page_bytes`` and ``params_nbytes`` are the reference's (int8
  pages count their f32 scales); an unload drops the engine, so nothing
  keeps its cache or weights alive.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.serving import ModelPool as JaxModelPool  # noqa: E402
from repro.serving import MultiModelServeEngine as JaxMM  # noqa: E402
from repro.serving import PagePool as JaxPagePool  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import kv_page_bytes as jax_kv_page_bytes  # noqa: E402
from repro.serving import params_nbytes as jax_params_nbytes  # noqa: E402
from repro_torch.analysis.invariants import InvariantError  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import (ModelPool,  # noqa: E402
                                 MultiModelServeEngine, PagePool, Request,
                                 ServeEngine, kv_page_bytes, params_nbytes)

pytestmark = [pytest.mark.torch_port, pytest.mark.multimodel]
torch.set_num_threads(2)

CPU = torch.device("cpu")
ENGINE_KW = dict(n_lanes=2, max_len=32, dispatch_n=4, rng_seed=7)
PAGE = 8
ARCHS = {"a": "qwen2.5-1.5b", "b": "olmo-1b"}
STATS = ("model_swaps", "swap_bytes", "swap_seconds", "weight_evictions",
         "kv_pages_shrunk", "kv_pages_grown")


@pytest.fixture(scope="module")
def two_models():
    """{"port": {mid: (cfg, params)}, "ref": {mid: (jcfg, jparams)}},
    float32, model b seeded apart from a."""
    port, ref = {}, {}
    for seed, (mid, arch) in enumerate(sorted(ARCHS.items())):
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                   dtype="float32")
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        jparams = jax_init_lm(jax.random.PRNGKey(seed), jcfg)
        ref[mid] = (jcfg, jparams)
        port[mid] = (cfg, params_from_jax(jax.device_get(jparams), cfg, CPU))
    return {"port": port, "ref": ref}


def _with_kv(models, kv_quant):
    return {mid: (dataclasses.replace(c, kv_quant=kv_quant), p)
            for mid, (c, p) in models.items()}


def _dense_budget(models, nbytes, page_bytes):
    return sum(nbytes(p) + (ENGINE_KW["n_lanes"]
                            * (ENGINE_KW["max_len"] // PAGE) + 1)
               * page_bytes(c, PAGE) for c, p in models.values())


def _mk(models, side, hbm_bytes=None, **kw):
    """A multi-model engine of ``side`` ("port" or "ref") over a pool
    of ``models``; default budget: every model at its dense target."""
    pool_cls, mm_cls, nbytes, pbytes = (
        (ModelPool, MultiModelServeEngine, params_nbytes, kv_page_bytes)
        if side == "port" else
        (JaxModelPool, JaxMM, jax_params_nbytes, jax_kv_page_bytes))
    if hbm_bytes is None:
        hbm_bytes = _dense_budget(models, nbytes, pbytes)
    pool = pool_cls(hbm_bytes, page_size=PAGE)
    for mid in sorted(models):
        pool.register(mid, models[mid][0], models[mid][1])
    extra = {"device": "cpu"} if side == "port" else {}
    return mm_cls(pool, **dict(ENGINE_KW, **kw, **extra))


def _reqs(spec, side, seed=3, vocab=512):
    """Interleaved requests: spec = [(mid, plen, gen), ...]."""
    cls = Request if side == "port" else JaxRequest
    rng = np.random.default_rng(seed)
    return [cls(uid=uid, prompt=rng.integers(0, vocab, plen,
                                             dtype=np.int32),
                max_new_tokens=gen, model_id=mid)
            for uid, (mid, plen, gen) in enumerate(spec)]


def _solo_streams(models, reqs, mid, **kw):
    cfg, params = models[mid]
    solo = [Request(uid=r.uid, prompt=r.prompt.copy(),
                    max_new_tokens=r.max_new_tokens)
            for r in reqs if r.model_id == mid]
    eng = ServeEngine(cfg, params, paged=True, page_size=PAGE,
                      device="cpu", **dict(ENGINE_KW, **kw))
    eng.run(solo)
    return [r.generated for r in solo]


def _serve_both(two_models, spec, hbm=None, kv_quant=None, **kw):
    """Serve ``spec`` on the port's and the reference's multi-model
    engines; return (port engine, port requests) after checking the
    streams and swap counters are the reference's."""
    out = {}
    for side in ("port", "ref"):
        models = _with_kv(two_models[side], kv_quant)
        budget = hbm(models, side) if hbm is not None else None
        mm = _mk(models, side, hbm_bytes=budget, **kw)
        reqs = _reqs(spec, side)
        mm.run(reqs)
        out[side] = (mm, reqs)
    (mm, reqs), (jmm, jreqs) = out["port"], out["ref"]
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert {k: mm.stats[k] for k in STATS} == \
        {k: jmm.stats[k] for k in STATS}
    assert dict(mm.pool.stats) == dict(jmm.pool.stats)
    return mm, reqs


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_two_models_concurrent_token_exact(two_models, temperature,
                                           kv_quant):
    spec = [("a", 5, 8), ("b", 7, 6), ("a", 9, 8), ("b", 4, 6),
            ("a", 6, 8)]
    mm, reqs = _serve_both(two_models, spec, kv_quant=kv_quant,
                           temperature=temperature)
    models = _with_kv(two_models["port"], kv_quant)
    for mid in ("a", "b"):
        got = [r.generated for r in reqs if r.model_id == mid]
        assert got == _solo_streams(models, reqs, mid,
                                    temperature=temperature), mid
    assert mm.stats["model_swaps"] == 2           # one cold load each
    for eng in mm.engines.values():
        eng.pool.check()
        assert eng.pool.n_in_use == 0


def _tight(models, side):
    nbytes, pbytes = ((params_nbytes, kv_page_bytes) if side == "port"
                      else (jax_params_nbytes, jax_kv_page_bytes))
    (ca, pa), (cb, pb) = models["a"], models["b"]
    return (nbytes(pa) + nbytes(pb) + 6 * pbytes(ca, PAGE)
            + 2 * pbytes(cb, PAGE))


def test_exactness_survives_tight_budget_churn(two_models):
    """A budget too small for both dense pools forces shrinks and LRU
    weight evictions -- the reference's, count for count -- and moves no
    token."""
    spec = [("a" if i % 2 == 0 else "b", 5 + i % 3, 6) for i in range(8)]
    mm, reqs = _serve_both(two_models, spec, hbm=_tight)
    assert mm.stats["weight_evictions"] > 0
    assert mm.stats["model_swaps"] > 2
    assert mm.stats["kv_pages_shrunk"] > 0
    for mid in ("a", "b"):
        got = [r.generated for r in reqs if r.model_id == mid]
        assert got == _solo_streams(two_models["port"], reqs, mid), mid


def test_unload_reload_round_trips_exactly(two_models):
    """Serve a, unload it, serve b, reload a, serve more a: the whole a
    stream equals one uninterrupted single-engine run, and the swaps
    are the reference's."""
    streams = {}
    for side in ("port", "ref"):
        mm = _mk(two_models[side], side)
        first = _reqs([("a", 5, 6), ("a", 7, 6)], side, seed=5)
        mm.run(first)
        assert mm.unload("a")
        assert "a" not in mm.resident_models
        mm.run(_reqs([("b", 6, 6)], side, seed=6))
        later = _reqs([("a", 9, 6)], side, seed=8)
        mm.run(later)                             # transparent reload
        assert mm.pool.entries["a"].loads == 2
        assert mm.stats["model_swaps"] == 3       # a, b, a again
        streams[side] = ([r.generated for r in first + later],
                         {k: mm.stats[k] for k in STATS},
                         mm.model_stats()["a"]["generated_tokens"])
        if side == "port":
            all_a = first + later
            assert streams[side][0] == _solo_streams(two_models["port"],
                                                     all_a, "a")
    assert streams["port"] == streams["ref"]


def test_live_model_is_pinned_against_unload(two_models):
    models = two_models["port"]
    wa, wb = params_nbytes(models["a"][1]), params_nbytes(models["b"][1])
    bt = ENGINE_KW["max_len"] // PAGE
    tight = wa + wb + (2 * bt + 1) * kv_page_bytes(models["a"][0], PAGE)
    mm = _mk(models, "port", hbm_bytes=tight)
    req = _reqs([("a", 5, 8)], "port")[0]
    assert mm.admit(req)
    assert mm.engines["a"].live_lanes()
    assert not mm.unload("a")                     # pinned: live lanes
    assert mm.ensure_resident("b") is None        # cannot evict a either
    assert "a" in mm.resident_models
    while mm.engines["a"].live_lanes():
        mm.decode_n()
    assert mm.unload("a")                         # idle now: allowed
    assert mm.ensure_resident("b") is not None


def _trade(models, side):
    """a's dense pool fits alone; b's minimum residency is two a-pages
    short, so b's arrival must carve them out of a's pool."""
    nbytes, pbytes = ((params_nbytes, kv_page_bytes) if side == "port"
                      else (jax_params_nbytes, jax_kv_page_bytes))
    (ca, pa), (cb, pb) = models["a"], models["b"]
    bt = ENGINE_KW["max_len"] // PAGE
    dense_a = ENGINE_KW["n_lanes"] * bt
    return (nbytes(pa) + (dense_a + 1) * pbytes(ca, PAGE)
            + nbytes(pb) + (bt + 1) * pbytes(cb, PAGE)
            - 2 * pbytes(ca, PAGE))


def test_weight_residency_trades_off_against_kv_pages(two_models):
    """Loading b shrinks a's free pages by the reference's count (the
    budget is conserved); unloading b grows them back."""
    seen = {}
    for side in ("port", "ref"):
        models = two_models[side]
        dense_a = ENGINE_KW["n_lanes"] * (ENGINE_KW["max_len"] // PAGE)
        mm = _mk(models, side, hbm_bytes=_trade(models, side))
        assert mm.load("a")
        before = mm.kv_pages_active()["a"]
        assert before == dense_a
        assert mm.load("b")
        after = mm.kv_pages_active()["a"]
        assert after < before
        assert mm.stats["kv_pages_shrunk"] == before - after
        assert mm.pool.free_bytes() >= 0
        used = mm.pool.used_bytes()
        assert mm.unload("b")
        assert mm.kv_pages_active()["a"] == before
        assert mm.stats["kv_pages_grown"] == before - after
        for eng in mm.engines.values():
            eng.pool.check()
        seen[side] = (before, after, used, mm.pool.used_bytes())
    assert seen["port"] == seen["ref"]


def test_register_rejects_model_larger_than_board(two_models):
    pool = ModelPool(1024, page_size=PAGE)
    cfg, params = two_models["port"]["a"]
    with pytest.raises(InvariantError, match="exceed the board"):
        pool.register("too-big", cfg, params)


def test_pagepool_shrink_grow_respects_reservations():
    pool = PagePool(8, PAGE)
    assert pool.reserve(3)
    assert pool.shrink(100) == 5                  # never promised pages
    assert pool.available() == 0
    assert pool.n_disabled == 5 and pool.n_active == 3
    pages = pool.alloc(2)
    assert pool.grow(2) == 2
    pool.free(pages)
    pool.unreserve(1)
    assert pool.grow(100) == 3
    assert pool.n_free == 8 and pool.n_disabled == 0
    pool.check()


def _pool_state(pool):
    return (list(pool._free), sorted(pool._in_use), list(pool._disabled),
            dict(sorted(pool._refcount.items())), pool._reserved, pool.hwm,
            pool.n_active)


@pytest.mark.parametrize("seed", range(4))
def test_pagepool_churn_matches_reference(seed):
    """Seeded reserve/alloc/share/cow/free/unreserve/shrink/grow churn:
    the port's pool hands out the reference's page ids and ends every
    op in the reference's state, conservation holding throughout."""
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(4, 24))
    ours, ref = PagePool(n_pages, PAGE), JaxPagePool(n_pages, PAGE)
    live = []
    ops = ("reserve", "alloc", "share", "cow", "free", "unreserve",
           "shrink", "grow")
    for _ in range(120):
        op, n = ops[int(rng.integers(len(ops)))], int(rng.integers(0, 10))
        if op == "reserve":
            assert ours.reserve(n) == ref.reserve(n)
        elif op == "alloc":
            k = min(n, ours._reserved, ours.n_free)
            got = ours.alloc(k)
            assert got == ref.alloc(k)
            live.extend(got)
        elif op == "share":
            pages = live[-min(n, len(live)):] if n else []
            ours.share(pages)
            ref.share(pages)
            live.extend(pages)
        elif op == "cow":
            shared = sorted(p for p in set(live) if ours.refcount(p) >= 2)
            if shared and ours._reserved >= 1 and ours.n_free >= 1:
                old = shared[n % len(shared)]
                new = ours.cow(old)
                assert new == ref.cow(old)
                live.remove(old)
                live.append(new)
        elif op == "free":
            pages = [live.pop() for _ in range(min(n, len(live)))]
            ours.free(pages)
            ref.free(pages)
        elif op == "unreserve":
            k = min(n, ours._reserved)
            ours.unreserve(k)
            ref.unreserve(k)
        else:
            assert getattr(ours, op)(n) == getattr(ref, op)(n)
        ours.check()
        assert _pool_state(ours) == _pool_state(ref)


def test_sanitizer_follows_shrink_and_grow(two_models):
    """Every inner engine's strict page sanitizer shadows the shrinks
    and grows of a tight budget and finds nothing."""
    mm = _mk(two_models["port"], "port",
             hbm_bytes=_tight(two_models["port"], "port"), sanitize=True)
    spec = [("a" if i % 2 == 0 else "b", 5 + i % 3, 6) for i in range(6)]
    mm.run(_reqs(spec, "port"))
    assert mm.stats["kv_pages_shrunk"] > 0
    for mid, eng in mm.engines.items():
        eng._sanitizer.crosscheck(eng.pool)       # raises on a mismatch
        assert eng.registry[f"{mid}.pool.pages.disabled"].value \
            == eng.pool.n_disabled


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ["qwen2.5-1.5b", "olmo-1b", "hymba-1.5b",
                                  "mamba2-780m", "mistral-nemo-12b"])
def test_kv_page_bytes_match_reference(arch, smoke):
    for kv_quant in (None, "int8"):
        cfg = dataclasses.replace(get_config(arch, smoke=smoke),
                                  kv_quant=kv_quant)
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=smoke),
                                   kv_quant=kv_quant)
        assert kv_page_bytes(cfg, 16) == jax_kv_page_bytes(jcfg, 16)
    if arch == "qwen2.5-1.5b" and not smoke:
        assert kv_page_bytes(get_config(arch), 16) == 458752


def test_params_nbytes_and_gauges(two_models):
    for mid, (_, jparams) in two_models["ref"].items():
        assert params_nbytes(two_models["port"][mid][1]) \
            == jax_params_nbytes(jparams)
    mm = _mk(two_models["port"], "port",
             hbm_bytes=_trade(two_models["port"], "port"))
    assert mm.load("a") and mm.load("b")
    reg = mm.registry
    assert reg["modelpool.residents"].value == len(mm.resident_models)
    assert reg["modelpool.bytes.used"].value == mm.pool.used_bytes()
    assert reg["modelpool.bytes.free"].value == mm.pool.free_bytes() >= 0
    shrunk = sum(e.pool.n_disabled for e in mm.engines.values())
    assert shrunk > 0
    assert sum(reg[f"{m}.pool.pages.disabled"].value
               for m in mm.resident_models) == shrunk
    phys = mm.physical_kv_bytes()
    assert sum(phys.values()) > mm.pool.kv_bytes_resident()


@pytest.mark.parametrize("prefix_sharing", [False, True])
def test_unload_drops_the_engine(two_models, prefix_sharing):
    """After an unload nothing (graphs, registry gauges, the tracer)
    keeps the engine -- and with it its cache and weights -- alive."""
    mm = _mk(two_models["port"], "port", prefix_sharing=prefix_sharing)
    mm.run(_reqs([("a", 9, 4), ("a", 9, 4)], "port"))
    ref = weakref.ref(mm.engines["a"])
    cache = weakref.ref(mm.engines["a"].cache["k_pages"])
    assert mm.unload("a")
    gc.collect()
    assert ref() is None and cache() is None
    assert mm.registry["a.pool.pages.in_use"].value == 0
