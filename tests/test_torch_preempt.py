"""Evict and restore of a live lane (``LaneCheckpoint``), on every paged
engine, held against the uninterrupted serve and against the reference.

* a lane evicted mid-decode and restored, into the same engine (after
  its neighbour ran on alone) or into a fresh one with the same
  ``n_lanes``, seed and temperature, continues the uninterrupted
  stream bit for bit, greedy and at t=0.8, for the dense engine (KV in
  float32 and in int8), mamba2 (state only, no pages) and hymba (window
  pages and state); the restored pages equal the checkpoint's bytes,
  and the pool conserves its pages;
* a lane admitted over a prefix-cache hit (its head pages shared with
  the cache) is evicted and restored on the same engine and on a fresh
  one: its stream equals the unshared serve's;
* checkpoints cross frameworks: one taken on the reference's engine
  restores into the port's and continues the reference's own
  uninterrupted stream, and one taken on the port's restores into the
  reference's; the two engines' checkpoints of the same lane have the
  same fields, keys and layout, and their pages agree within 1e-5;
* a payload that does not fit (a head dimension short, which an indexed
  write would broadcast, or a pool missing), one that fails while it is
  written, or a page size that differs is refused, and leaves no page
  or reservation behind.
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
from repro.serving.engine import (  # noqa: E402
    LaneCheckpoint as JaxLaneCheckpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import (LaneCheckpoint, Request,  # noqa: E402
                                 ServeEngine)

pytestmark = [pytest.mark.torch_port, pytest.mark.preempt]
torch.set_num_threads(2)

CPU = torch.device("cpu")
ENGINE_KW = dict(n_lanes=2, max_len=48, dispatch_n=4, paged=True,
                 page_size=8, rng_seed=7)
#: engine kinds: (arch, kv_quant)
KINDS = {"dense": ("qwen2.5-1.5b", None), "int8": ("qwen2.5-1.5b", "int8"),
         "mamba2": ("mamba2-780m", None), "hymba": ("hymba-1.5b", None)}


@pytest.fixture(scope="module")
def models():
    """``models(kind)`` -> (jcfg, jparams, cfg, params), float32, the
    reference's weights converted through numpy; each built once."""
    built = {}

    def get(kind):
        arch, kv_quant = KINDS[kind]
        if arch not in built:
            jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                       dtype="float32")
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="float32")
            jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
            built[arch] = (jcfg, jparams, cfg,
                           params_from_jax(jax.device_get(jparams), cfg,
                                           CPU))
        jcfg, jparams, cfg, params = built[arch]
        return (dataclasses.replace(jcfg, kv_quant=kv_quant), jparams,
                dataclasses.replace(cfg, kv_quant=kv_quant), params)
    return get


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _reqs(prompts, max_new, cls=Request):
    return [cls(uid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _drain(*engines):
    for eng in engines:
        while eng.live_lanes():
            eng.decode_n()


def _lane_bytes(eng, lane):
    """The lane's pages gathered through its block table, per pool."""
    idx = torch.tensor(eng.lane_pages(lane), dtype=torch.long)
    return {k: eng.cache[k][:, idx].clone() for k in eng.cache
            if k.endswith("_pages")}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("cross_engine", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_evict_restore_token_exact(models, kind, cross_engine, temperature):
    _, _, cfg, params = models(kind)
    prompts = _prompts(cfg, [5, 13], seed=1)
    kw = dict(ENGINE_KW, temperature=temperature)
    base = ServeEngine(cfg, params, device="cpu", **kw).run(
        _reqs(prompts, 12))

    reqs = _reqs(prompts, 12)
    src = ServeEngine(cfg, params, device="cpu", **kw)
    for r in reqs:
        assert src.admit(r)
    src.decode_n()                        # 4 tokens into each stream
    held, n_held = _lane_bytes(src, 0), len(src.lane_pages(0))
    ckpt = src.evict(0)
    assert ckpt.n_pages == n_held and src.lane_pages(0) == []
    assert sorted(ckpt.kv_pages) == sorted(held)
    for key, val in held.items():         # the checkpoint is the pages
        assert np.array_equal(ckpt.kv_pages[key], val.numpy())
    assert set(ckpt.ssm_state) == ({"ssm_h", "ssm_conv"} if cfg.has_ssm
                                   else set())
    src.decode_n()                        # lane 1 advances alone
    dst = ServeEngine(cfg, params, device="cpu", **kw) if cross_engine \
        else src
    assert dst.can_restore(ckpt) and dst.restore(ckpt)
    lane = dst.lane_req.index(reqs[0])
    for key, val in _lane_bytes(dst, lane).items():
        assert np.array_equal(val.numpy(), ckpt.kv_pages[key]), key
    for key, val in ckpt.ssm_state.items():
        assert np.array_equal(dst.cache[key][:, lane].numpy(), val), key
    _drain(src, dst)

    assert [r.generated for r in reqs] == [r.generated for r in base]
    for eng in (src, dst):
        eng.pool.check()
        assert eng.pool.n_in_use == 0
    assert src.stats["preemptions"] == 1
    assert dst.stats["restores"] == 1
    assert dst.stats["pages_migrated"] == ckpt.n_pages
    assert (ckpt.n_pages > 0) == (kind != "mamba2")


def _family(cfg):
    rng = np.random.default_rng(11)
    head = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32)]) for n in (4, 6)]


@pytest.mark.parametrize("cross_engine", [False, True])
@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_evict_restore_prefix_hit_lane(models, kind, cross_engine):
    """A lane admitted over a cache hit is evicted mid-decode: its shared
    pages are captured by value (the cache keeps its references), and
    the restored stream equals the unshared serve's."""
    _, _, cfg, params = models(kind)
    donor, consumer = _family(cfg)
    kw = dict(ENGINE_KW, temperature=0.8)
    base = ServeEngine(cfg, params, device="cpu", **kw).run(
        _reqs([donor, consumer], 10))

    skw = dict(kw, prefix_sharing=True)
    src = ServeEngine(cfg, params, device="cpu", **skw)
    dreq = Request(uid=0, prompt=donor.copy(), max_new_tokens=10)
    src.run([dreq])                       # the donor retires, cache warm
    creq = Request(uid=1, prompt=consumer.copy(), max_new_tokens=10)
    assert src.admit(creq)
    assert src.stats["prefix_hits"] == 1
    src.decode_n()
    lane = src.lane_req.index(creq)
    shared = [p for p in src.lane_pages(lane) if src.pool.is_shared(p)]
    assert shared
    ckpt = src.evict(lane)
    src.pool.check()
    assert all(src.pool.refcount(p) == 1 for p in shared)   # the cache's
    dst = ServeEngine(cfg, params, device="cpu", **skw) if cross_engine \
        else src
    assert dst.restore(ckpt)
    _drain(src, dst)
    assert [dreq.generated, creq.generated] == [r.generated for r in base]
    for eng in {id(src): src, id(dst): dst}.values():
        eng.prefix_cache.flush()
        eng.pool.check()
        assert eng.pool.n_in_use == 0


def _jax_to_port(ck, req):
    return LaneCheckpoint(
        req=req, lane_seed=ck.lane_seed, tok_idx=ck.tok_idx,
        remaining=ck.remaining, ctx_len=ck.ctx_len,
        next_token=ck.next_token, page_size=ck.page_size,
        kv_pages=dict(ck.kv_pages), ssm_state=dict(ck.ssm_state))


def _port_to_jax(ck, req):
    return JaxLaneCheckpoint(
        req=req, lane_seed=ck.lane_seed, tok_idx=ck.tok_idx,
        remaining=ck.remaining, ctx_len=ck.ctx_len,
        next_token=ck.next_token, page_size=ck.page_size,
        kv_pages=dict(ck.kv_pages), ssm_state=dict(ck.ssm_state))


@pytest.mark.parametrize("kind,temperature", [
    ("dense", 0.0), ("dense", 0.8), ("int8", 0.8), ("mamba2", 0.8),
    ("hymba", 0.0)])
def test_checkpoint_crosses_frameworks(models, kind, temperature):
    jcfg, jparams, cfg, params = models(kind)
    prompts = _prompts(cfg, [6, 11], seed=5)
    kw = dict(ENGINE_KW, temperature=temperature)
    jreqs_base = _reqs(prompts, 10, JaxRequest)
    JaxServeEngine(jcfg, jparams, **kw).run(jreqs_base)
    want = [r.generated for r in jreqs_base]

    # the same lane evicted from both engines at the same boundary
    jreqs, treqs = _reqs(prompts, 10, JaxRequest), _reqs(prompts, 10)
    jsrc = JaxServeEngine(jcfg, jparams, **kw)
    tsrc = ServeEngine(cfg, params, device="cpu", **kw)
    for jr, tr in zip(jreqs, treqs):
        assert jsrc.admit(jr) and tsrc.admit(tr)
    assert tsrc.decode_n() == jsrc.decode_n()
    jck, tck = jsrc.evict(1), tsrc.evict(1)
    for f in ("lane_seed", "tok_idx", "remaining", "ctx_len", "next_token",
              "page_size", "n_pages"):
        assert getattr(tck, f) == getattr(jck, f), f
    assert sorted(tck.kv_pages) == sorted(jck.kv_pages)
    assert sorted(tck.ssm_state) == sorted(jck.ssm_state)
    for part in ("kv_pages", "ssm_state"):
        for key, val in getattr(jck, part).items():
            got = getattr(tck, part)[key]
            assert got.shape == val.shape and got.dtype == val.dtype, key
            if got.dtype == np.int8:       # quantized: a rounding apart
                assert np.abs(got.astype(int) - val.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, val, atol=1e-5, rtol=0)

    # the reference's checkpoint into a fresh port engine, and the port's
    # into a fresh reference engine: both continue the reference's stream
    into_port = ServeEngine(cfg, params, device="cpu", **kw)
    moved = Request(uid=1, prompt=prompts[1].copy(), max_new_tokens=10,
                    generated=list(jck.req.generated))
    assert into_port.restore(_jax_to_port(jck, moved))
    into_ref = JaxServeEngine(jcfg, jparams, **kw)
    moved_back = JaxRequest(uid=1, prompt=prompts[1].copy(),
                            max_new_tokens=10,
                            generated=list(tck.req.generated))
    assert into_ref.restore(_port_to_jax(tck, moved_back))
    _drain(jsrc, tsrc, into_port, into_ref)
    assert moved.generated == want[1]
    assert moved_back.generated == want[1]
    assert jreqs[0].generated == treqs[0].generated == want[0]


def test_restore_failure_and_page_size_leave_no_page(models):
    _, _, cfg, params = models("dense")
    eng = ServeEngine(cfg, params, device="cpu", **ENGINE_KW)
    req = Request(uid=0, prompt=_prompts(cfg, [9], seed=2)[0],
                  max_new_tokens=8)
    assert eng.admit(req)
    eng.decode_n()
    ckpt = eng.evict(0)
    assert ckpt.n_pages == -(-(ckpt.ctx_len + 1) // 8)
    assert all(isinstance(v, np.ndarray) for v in ckpt.kv_pages.values())
    assert ckpt.nbytes() == sum(v.nbytes for v in ckpt.kv_pages.values())
    for bad in ({k: v[:, :, :1] for k, v in ckpt.kv_pages.items()},
                {k: v for k, v in ckpt.kv_pages.items() if k != "v_pages"}):
        with pytest.raises(AssertionError, match="does not fit"):
            eng.restore(dataclasses.replace(ckpt, kv_pages=bad))
    # a payload that fits but fails while it is written: the pages and
    # the reservation taken for it go back
    unreadable = {k: np.full(v.shape, "x") for k, v in ckpt.kv_pages.items()}
    with pytest.raises(ValueError):
        eng.restore(dataclasses.replace(ckpt, kv_pages=unreadable))
    eng.pool.check()
    assert eng.pool.n_in_use == 0 and eng.pool.available() == eng.pool.n_pages
    assert eng.free_lanes() == [0, 1]
    other = ServeEngine(cfg, params, device="cpu",
                        **dict(ENGINE_KW, page_size=16))
    with pytest.raises(AssertionError):
        other.restore(ckpt)
    assert eng.restore(ckpt)
    _drain(eng)
    assert req.done and len(req.generated) == 8
