"""The port's prefill as one CUDA graph per prompt bucket, checked where it
can be without a card, and the last reference functions the port
mirrors.

* the function the engine captures for a bucket (``_prefill_block``)
  makes no tensor from Python data (``torch.tensor``/``torch.as_tensor``
  patched to refuse it, as for the decode dispatch) on both layouts, for
  qwen2.5-1.5b (KV in float32 and int8), mamba2-780m, hymba-1.5b and
  moonshot-v1-16b-a3b;
* each bucket's token and last-position buffers keep their address over
  every prefill of a serve;
* a prompt in bucket 8 beside ``dispatch_n=8``: ``prefill_compiles`` and
  ``decode_compiles`` equal the reference engine's, so the prefill key
  ``("prefill", 8)`` does not take the decode graph of ``n_steps`` 8;
* ``lm_prefill`` and ``lm_decode_sample_step`` against the reference's;
  the reference's modeled fetch counts, ``iter_flight_dumps`` and the
  ``repro_torch.models`` re-exports.

``prefill_compiles`` and the streams with ``prefill_bucketing`` on and
off are held against the reference in ``tests/test_torch_engine_dense.py``;
a replayed prefill against the eager one on the card is in
``tests/test_torch_graphs_card.py``.  SMOKE configs in float32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.models as jax_models  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    kv_blocks_fetched as jax_kv_blocks_fetched,
    kv_pages_fetched as jax_kv_pages_fetched)
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    lm_decode_sample_step as jax_lm_decode_sample_step,
    lm_prefill as jax_lm_prefill)
from repro.obs.flight import FlightRecorder as JaxFlightRecorder  # noqa: E402
from repro.obs.flight import (  # noqa: E402
    iter_flight_dumps as jax_iter_flight_dumps)
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
import repro_torch.models as models  # noqa: E402
from repro_torch import rng as trng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    kv_blocks_fetched, kv_pages_fetched)
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_cache, lm_decode_sample_step, lm_prefill)
from repro_torch.obs.flight import (FlightRecorder,  # noqa: E402
                                    iter_flight_dumps)
from repro_torch.serving import STATS_KEYS, Request, ServeEngine  # noqa: E402
from test_torch_cuda_graphs import _guarded, _no_host_tensors  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
MAX_LEN, PAGE = 64, 8
#: prompt lengths of the serves: buckets 8, 16 and 32 twice or more, and
#: one past ``MAX_LEN - 1`` (its tail is kept)
PLENS = [5, 12, 30, 7, 20, 70, 14, 3]


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", **kw)


def _jcfg(arch):
    return dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype="float32")


@pytest.fixture(scope="module")
def ported():
    """Port-only random weights of four SMOKE families (no reference)."""
    return {arch: build_model(_cfg(arch)).init(
        torch.Generator().manual_seed(0), CPU)
        for arch in ("qwen2.5-1.5b", "mamba2-780m", "hymba-1.5b",
                     "moonshot-v1-16b-a3b")}


@pytest.fixture(scope="module")
def reference():
    """Reference weights, and the port's from them, by arch."""
    out = {}
    for arch in ("qwen2.5-1.5b", "mamba2-780m", "hymba-1.5b"):
        jcfg, cfg = _jcfg(arch), _cfg(arch)
        jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, jparams, cfg,
                     params_from_jax(jax.device_get(jparams), cfg, CPU))
    return out


def _requests(vocab, plens=PLENS, gen=3, seed=4):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, vocab, p).astype(np.int32),
                    max_new_tokens=gen) for i, p in enumerate(plens)]


def _engine(arch, params, paged, kv_quant=None, **kw):
    cfg = _cfg(arch, kv_quant=kv_quant)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    return ServeEngine(cfg, params, n_lanes=2, max_len=MAX_LEN,
                       dispatch_n=4, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen2.5-1.5b", None), ("qwen2.5-1.5b", "int8"),
    ("mamba2-780m", None), ("hymba-1.5b", None),
    ("moonshot-v1-16b-a3b", None)])
def test_prefill_block_makes_no_host_tensor(ported, arch, kv_quant, paged):
    """Every prefill of a serve runs the bucket's function with host-made
    tensors refused (a pageable host-to-device copy, which stream
    capture refuses); the host work around it is not patched.  Each
    prefill goes through the ``("prefill", bucket)`` key."""
    eng = _engine(arch, ported[arch], paged, kv_quant, temperature=0.8)
    calls = []
    eng._prefill_block = _guarded(eng._prefill_block, calls)
    reqs = eng.run(_requests(eng.cfg.vocab_size))
    assert all(r.done and r.generated for r in reqs)
    assert len(calls) == len(reqs)
    buckets = set(eng.timings["prefill_replayed"])
    assert eng.stats["prefill_compiles"] == len(buckets) == 4
    assert {k for k in eng.graphs._seen if isinstance(k, tuple)} == {
        ("prefill", b) for b in buckets}
    with pytest.raises(AssertionError, match="captured path"):
        with _no_host_tensors([]):
            torch.tensor(1.0)               # the guard itself bites


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_buffers_keep_their_addresses(ported, paged):
    eng = _engine("qwen2.5-1.5b", ported["qwen2.5-1.5b"], paged)
    seen = {}
    block = eng._prefill_block

    def recorded(bucket):
        tokens, last_pos = eng._prefill_in[bucket]
        seen.setdefault(bucket, set()).add((tokens.data_ptr(),
                                            last_pos.data_ptr()))
        return block(bucket)

    eng._prefill_block = recorded
    reqs = eng.run(_requests(eng.cfg.vocab_size))
    assert all(r.done for r in reqs)
    assert sorted(seen) == [8, 16, 32, 64]
    flags = eng.timings["prefill_replayed"]
    assert sum(len(v) for v in flags.values()) == len(reqs)
    assert not any(any(v) for v in flags.values())    # no replay on CPU
    for bucket, ptrs in seen.items():
        tokens, last_pos = eng._prefill_in[bucket]
        assert ptrs == {(tokens.data_ptr(), last_pos.data_ptr())}
        assert tuple(tokens.shape) == (1, bucket)
        assert len(flags[bucket]) > 1 or bucket == 64


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_keys_do_not_collide(reference, paged):
    """Bucket 8 and ``n_steps`` 8 in one engine: both counters equal the
    reference's, with both keys in use."""
    jcfg, jparams, cfg, params = reference["qwen2.5-1.5b"]
    kw = dict(n_lanes=2, max_len=MAX_LEN, dispatch_n=8, rng_seed=1)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, p).astype(np.int32)
               for p in (6, 8, 3)]
    jreqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=12)
             for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=12)
             for i, p in enumerate(prompts)]
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    jeng.run(jreqs)
    teng.run(treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert {("prefill", 8), 8} <= teng.graphs._seen
    assert teng.stats["prefill_compiles"] == jeng.stats[
        "prefill_compiles"] == 1
    assert teng.stats["decode_compiles"] == jeng.stats["decode_compiles"]
    assert teng.stats["decode_compiles"] >= 2                # 8, then 4
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k


@pytest.mark.parametrize("arch", ["qwen2.5-1.5b", "mamba2-780m",
                                  "hymba-1.5b"])
def test_lm_prefill_matches_reference(reference, arch):
    """The prompt streamed into a fresh dense cache: the last logits and
    every cache tensor within 1e-5 of the reference's (hymba's 40 tokens
    wrap its window of 32)."""
    jcfg, jparams, cfg, params = reference[arch]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jlogits, jcache = jax_lm_prefill(jparams, jax.numpy.asarray(toks), jcfg,
                                     MAX_LEN)
    logits, cache = lm_prefill(params, torch.from_numpy(toks), cfg, MAX_LEN)
    assert sorted(cache) == sorted(jcache)
    assert sorted(cache) == sorted(init_cache(cfg, 2, MAX_LEN, device=CPU))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    for key in sorted(jcache):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    assert cache["len"].tolist() == [40, 40]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_lm_decode_sample_step_matches_reference(reference, temperature):
    """Two fused steps after a streamed prompt, each sampled with the same
    threefry key on both sides: the tokens are equal."""
    jcfg, jparams, cfg, params = reference["qwen2.5-1.5b"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    _, jcache = jax_lm_prefill(jparams, jax.numpy.asarray(toks), jcfg,
                               MAX_LEN)
    _, cache = lm_prefill(params, torch.from_numpy(toks), cfg, MAX_LEN)
    jtok, tok = jax.numpy.asarray(toks[:, -1]), torch.from_numpy(toks[:, -1])
    for step in range(2):
        jtok, jcache = jax_lm_decode_sample_step(
            jparams, jcfg, jcache, jtok,
            jax.random.fold_in(jax.random.PRNGKey(7), step),
            temperature=temperature)
        tok, cache = lm_decode_sample_step(
            params, cfg, cache, tok, trng.fold_in(trng.PRNGKey(7), step),
            temperature=temperature)
        assert tok.dtype == torch.int32
        assert tok.tolist() == np.asarray(jtok).tolist(), step
    assert cache["len"].tolist() == [11, 11, 11]


def test_fetch_counts_match_reference():
    """Lengths 0, 1, bk, bk + 1 and past the table's width."""
    bk, sk, ps, width = 64, 512, 16, 4
    lens = np.array([0, 1, bk, bk + 1, 200, sk, 700])
    got = kv_blocks_fetched(lens, sk, bk)
    assert got.dtype == np.int64
    assert got.tolist() == jax_kv_blocks_fetched(lens, sk, bk).tolist()
    assert got.tolist() == [1, 1, 1, 2, 4, 8, 11]
    assert kv_blocks_fetched(lens, 32).tolist() == \
        jax_kv_blocks_fetched(lens, 32).tolist()           # bk > sk
    plens = np.array([0, 1, ps, ps + 1, 4 * ps, 200])
    pages = kv_pages_fetched(plens, width, ps)
    assert pages.tolist() == jax_kv_pages_fetched(plens, width, ps).tolist()
    assert pages.tolist() == [1, 1, 1, 2, 4, 4]


def test_iter_flight_dumps_matches_reference(tmp_path):
    """Two recorders on each side, dumped the same ways: the same paths
    in the same order."""
    def dumps(cls, iterate, sub):
        recs = [cls(name="a"), cls(name="b", capacity=4)]
        for i, rec in enumerate(recs):
            rec.record("span", name=f"s{i}")
        base = tmp_path / sub
        base.mkdir()
        recs[0].dump(str(base / "first.jsonl"), reason="x")
        recs[1].dump(str(base / "second.jsonl"))
        recs[0].dump(str(base / "third.jsonl"))
        return [p[len(str(base)):] for p in iterate(recs)]

    got = dumps(FlightRecorder, iter_flight_dumps, "port")
    want = dumps(JaxFlightRecorder, jax_iter_flight_dumps, "ref")
    assert got == want == ["/first.jsonl", "/third.jsonl", "/second.jsonl"]
    assert list(iter_flight_dumps([])) == []


def test_models_reexports_match_reference():
    assert set(jax_models.__all__) <= set(models.__all__)
    for name in ("MoEConfig", "SSMConfig", "cross_entropy", "pad_vocab"):
        assert getattr(models, name) is getattr(common, name)
    assert models.pad_vocab(100) == jax_models.pad_vocab(100)
