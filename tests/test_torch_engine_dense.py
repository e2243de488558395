"""Port ``ServeEngine()`` (fixed-lane, the default) against the reference.

Both engines serve the same request list (more requests than lanes,
varied prompt lengths, one prompt longer than ``max_len - 1``) in
lockstep, greedy and with ``temperature=0.8`` at two ``rng_seed``s:
every admission, every ``decode_n`` block and every ``STATS_KEYS``
counter must be identical.  The paged engine is held against the
reference with temperature too, and the port's two layouts must give
identical streams.  SMOKE config in float32, reference parameters
converted through numpy; token streams are compared exactly.
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
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.serving import STATS_KEYS, Request, ServeEngine  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
N_LANES, MAX_LEN, PAGE, DISPATCH = 3, 64, 8, 4
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
            assert teng.can_admit(treqs[i]) == jeng.can_admit(jreqs[i])
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
    return teng, treqs


@pytest.mark.parametrize("temperature,rng_seed,bucketing", [
    (0.0, 0, True), (0.8, 0, True), (0.8, 5, True), (0.0, 0, False),
    (0.8, 5, False)], ids=["0.0-0", "0.8-0", "0.8-5", "0.0-0-unbucketed",
                           "0.8-5-unbucketed"])
def test_fixed_lane_lockstep_matches_reference(setup, temperature, rng_seed,
                                               bucketing):
    """Also with ``prefill_bucketing=False``: one prefill shape (on the
    card, one graph) per prompt length, as the reference compiles one
    executable per length."""
    before = launch_counts()
    teng, treqs = _lockstep(setup, temperature=temperature,
                            rng_seed=rng_seed, prefill_bucketing=bucketing)
    assert not teng.paged and teng.pool is None
    assert teng.stats["kv_pages_hwm"] == 0
    assert teng.stats["prefill_compiles"] == (4 if bucketing else 7)
    assert np.array_equal(teng.cache["len"].numpy(), np.zeros(N_LANES))
    for tr in treqs:
        plen = min(PLENS[tr.uid], MAX_LEN - 1)
        assert len(tr.generated) == min(GENS[tr.uid],
                                        max(MAX_LEN - 1 - plen, 1))
    assert launch_counts() == before        # CPU: no kernel launched


def test_paged_temperature_lockstep_matches_reference(setup):
    teng, _ = _lockstep(setup, temperature=0.8, rng_seed=5, paged=True,
                        page_size=PAGE)
    teng.pool.check()


def test_fixed_lane_and_paged_streams_identical(setup):
    """Keys fold from (admission index, token index), so the layout
    does not show in any stream, greedy or sampled; nor does the
    dispatch size or the prefill bucketing."""
    _, _, cfg, params, prompts = setup
    by_temperature = {}
    for temperature in (0.0, 0.8):
        streams = []
        for kw in (dict(paged=False), dict(paged=True, page_size=PAGE),
                   dict(paged=False, dispatch_n=3, prefill_bucketing=False)):
            kw = dict(dict(dispatch_n=DISPATCH), **kw)
            eng = ServeEngine(cfg, params, n_lanes=N_LANES, max_len=MAX_LEN,
                              temperature=temperature, rng_seed=2,
                              device="cpu", **kw)
            reqs = eng.run(_requests(prompts, Request))
            streams.append([r.generated for r in reqs])
        assert streams[0] == streams[1] == streams[2], temperature
        by_temperature[temperature] = streams[0]
    assert by_temperature[0.0] != by_temperature[0.8]   # it does sample


def test_decode_step_and_never_admissible(setup):
    _, _, cfg, params, prompts = setup
    eng = ServeEngine(cfg, params, n_lanes=1, max_len=MAX_LEN, device="cpu")
    req = Request(uid=0, prompt=prompts[0], max_new_tokens=3)
    assert eng.can_admit(req) and eng.admit(req)
    assert not eng.can_admit(Request(uid=1, prompt=prompts[1],
                                     max_new_tokens=3))
    toks = [eng.decode_step()[0] for _ in range(3)]
    assert toks == req.generated and req.done
    rej = eng._never_admissible(req)
    assert rej.need_pages is None and rej.pool_pages is None
    assert eng.stats["admit_rejected"] == 1
