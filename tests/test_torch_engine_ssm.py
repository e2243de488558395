"""Port ``ServeEngine`` serving the ssm family (mamba2 SMOKE) against the
reference, on both layouts.

Both engines serve the same request list (more requests than lanes,
varied prompt lengths, one prompt longer than ``max_len - 1``) in
lockstep, greedy and at ``temperature=0.8``, fixed-lane and paged:
every admission, every ``decode_n`` block and every ``STATS_KEYS``
counter (``prefill_compiles``, ``ssm_prefill_compiles``,
``decode_dispatches``, ``generated_tokens`` among them) must be
identical.  SMOKE in float32, reference parameters converted through
numpy; token streams are compared exactly.  Also: a re-admitted lane
starts from zero state (the reference's
``test_ssm_lane_reuse_isolation``), the paged layout holds no pages,
and the ssm caches' layout.
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
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import STATS_KEYS, Request, ServeEngine  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
N_LANES, MAX_LEN, PAGE, DISPATCH = 2, 64, 8, 4
PLENS = [5, 12, 30, 9, 70, 17]             # 70 > MAX_LEN - 1: truncated
GENS = [10, 6, 12, 20, 8, 5]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("mamba2-780m", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    return jcfg, jparams, cfg, params, prompts


def _requests(prompts, cls, gens=GENS):
    return [cls(uid=i, prompt=p.copy(), max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_lockstep_matches_reference(setup, paged, temperature):
    jcfg, jparams, cfg, params, prompts = setup
    kw = dict(n_lanes=N_LANES, max_len=MAX_LEN, dispatch_n=DISPATCH,
              temperature=temperature, rng_seed=3)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    jreqs, treqs = _requests(prompts, JaxRequest), _requests(prompts,
                                                             Request)
    before = launch_counts()
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
    assert teng.stats["ssm_prefill_compiles"] == 4      # 8, 16, 32, 64
    assert teng.stats["kv_pages_hwm"] == 0
    assert launch_counts() == before          # CPU: no kernel launched


def test_paged_ssm_holds_no_pages(setup):
    """An attention-free paged engine: a pool of 0 pages, admission
    needing 0, no block tables, the same streams as fixed-lane."""
    _, _, cfg, params, prompts = setup
    streams = []
    for kw in (dict(), dict(paged=True, page_size=PAGE),
               dict(prefill_bucketing=False, dispatch_n=3)):
        eng = ServeEngine(cfg, params, n_lanes=N_LANES, max_len=MAX_LEN,
                          device="cpu", **dict(dict(dispatch_n=DISPATCH),
                                               **kw))
        if eng.paged:
            assert eng.pool.n_pages == 0 and eng._bt_width == 0
            assert "block_tables" not in eng.cache
            assert all(eng.admission_pages(r) == 0
                       for r in _requests(prompts, Request))
        reqs = eng.run(_requests(prompts, Request))
        if eng.paged:
            eng.pool.check()
            assert eng.pool.n_in_use == 0
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1] == streams[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True])
def test_ssm_lane_reuse_isolation(dtype, paged):
    """Re-admitting a lane must not leak the previous request's state:
    request B through a reused lane equals B served solo in a fresh
    engine (the reference's test of the same name), and so does the
    lane's state right after B's admission, bit for bit."""
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              dtype=dtype)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(8)
    pa, pb = (rng.integers(0, cfg.vocab_size, n).astype(np.int32)
              for n in (6, 7))
    kw = dict(n_lanes=1, max_len=32, dispatch_n=4, device="cpu",
              paged=paged, page_size=PAGE)

    def admit_b(eng):
        req = Request(uid=1, prompt=pb.copy(), max_new_tokens=4)
        assert eng.admit(req)
        state = {k: eng.cache[k].clone() for k in ("ssm_h", "ssm_conv")}
        eng.run([])
        return req, state

    solo, solo_state = admit_b(ServeEngine(cfg, params, **kw))
    eng = ServeEngine(cfg, params, **kw)
    eng.run([Request(uid=0, prompt=pa.copy(), max_new_tokens=4)])
    assert eng.cache["ssm_h"].any()            # A left its state behind
    reused, state = admit_b(eng)
    for k in state:
        assert torch.equal(state[k], solo_state[k]), k
    assert reused.generated == solo.generated
    assert len(solo.generated) == 4


def test_ssm_cache_layout():
    cfg = get_config("mamba2-780m", smoke=True)       # bfloat16
    model = build_model(cfg)
    nh = 2 * cfg.d_model // cfg.ssm.head_dim
    conv_ch = 2 * cfg.d_model + 2 * cfg.ssm.state_dim
    for cache in (model.init_cache(3, 64, device=CPU),
                  model.init_paged_cache(3, 64, page_size=8, device=CPU)):
        assert sorted(cache) == ["len", "ssm_conv", "ssm_h"]
        assert tuple(cache["ssm_h"].shape) == (
            cfg.n_layers, 3, nh, cfg.ssm.state_dim, cfg.ssm.head_dim)
        assert tuple(cache["ssm_conv"].shape) == (
            cfg.n_layers, 3, cfg.ssm.conv_width - 1, conv_ch)
        assert cache["ssm_h"].dtype == cache["ssm_conv"].dtype == \
            torch.float32
        assert not cache["ssm_h"].any() and not cache["ssm_conv"].any()


def test_engine_timings_and_launcher(capsys):
    """``timed=True`` records the prompt streaming per prompt; the
    launcher serves the SMOKE ssm model on the CPU."""
    cfg = get_config("mamba2-780m", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    eng = ServeEngine(cfg, params, n_lanes=2, max_len=32, device="cpu",
                      timed=True)
    reqs = [Request(uid=i, prompt=np.arange(3 + i, dtype=np.int32),
                    max_new_tokens=3) for i in range(3)]
    eng.run(reqs)
    assert len(eng.timings["ssm_stream"]) == 3
    assert sum(len(v) for v in eng.timings["prefill"].values()) == 3
    assert all(len(r.generated) == 3 for r in reqs)
    serve_launcher.main(["--arch", "mamba2-780m", "--smoke", "--device",
                         "cpu", "--requests", "3", "--prompt-len", "12",
                         "--gen", "4", "--lanes", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "'ssm_prefill_compiles': 1" in out
