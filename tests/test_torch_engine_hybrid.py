"""Port ``ServeEngine`` serving the hybrid family (hymba SMOKE: attention
with a sliding window of 32 beside Mamba-2 heads) against the reference,
on both layouts.

Both engines serve the same request list in lockstep, greedy and at
``temperature=0.8``, fixed-lane and paged, with the KV in the compute
dtype and in int8: more requests than lanes, a prompt that wraps the
window, a request whose decode crosses it, and a prompt longer than
``max_len - 1``.  Every admission, every ``decode_n`` block and every
``STATS_KEYS`` counter must be identical.  SMOKE in float32, reference
parameters converted through numpy; token streams are compared exactly.
Also: a re-admitted lane starts from zero SSM state (the reference's
``test_ssm_lane_reuse_isolation`` for hymba), the paged layout holds the
window's pages beside the dense state, and the launcher serves hymba
SMOKE on the CPU on both layouts.
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
#: window 32: the 40-token prompt wraps it, the 25-token one's decode
#: crosses it, 70 > MAX_LEN - 1 is truncated (and wraps)
PLENS = [5, 40, 25, 9, 70, 17]
GENS = [10, 6, 12, 20, 8, 5]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("hymba-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    return jcfg, jparams, cfg, params, prompts


def _requests(prompts, cls, gens=GENS):
    return [cls(uid=i, prompt=p.copy(), max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_lockstep_matches_reference(setup, paged, temperature, kv_quant):
    jcfg, jparams, cfg, params, prompts = setup
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
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
            if paged:
                lane = teng.lane_req.index(treqs[i])
                assert teng.lane_pages(lane) == list(jeng._lane_pages[lane])
        assert teng.decode_n(DISPATCH) == jeng.decode_n(DISPATCH)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.generated == jr.generated, tr.uid
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["ssm_prefill_compiles"] == 4      # 8, 16, 32, 64
    if paged:
        teng.pool.check()
        assert teng.stats["kv_pages_hwm"] > 0
    assert launch_counts() == before          # CPU: no kernel launched


def test_paged_hybrid_holds_window_pages(setup):
    """A hybrid paged engine: block tables of the window's page count
    beside the dense per-lane state, admission capped at that page set,
    the same streams as fixed-lane and as unbucketed prefill."""
    _, _, cfg, params, prompts = setup
    streams = []
    for kw in (dict(), dict(paged=True, page_size=PAGE),
               dict(prefill_bucketing=False, dispatch_n=3)):
        eng = ServeEngine(cfg, params, n_lanes=N_LANES, max_len=MAX_LEN,
                          device="cpu", **dict(dict(dispatch_n=DISPATCH),
                                               **kw))
        assert {"ssm_h", "ssm_conv"} <= set(eng.cache)
        if eng.paged:
            t_w = cfg.sliding_window // PAGE
            assert eng._bt_width == t_w
            assert tuple(eng.cache["block_tables"].shape) == (N_LANES, t_w)
            assert eng.pool.n_pages == N_LANES * t_w
            assert max(eng.admission_pages(r)
                       for r in _requests(prompts, Request)) == t_w
        else:
            assert eng.cache["k"].shape[3] == cfg.sliding_window
        reqs = eng.run(_requests(prompts, Request))
        if eng.paged:
            eng.pool.check()
            assert eng.pool.n_in_use == 0
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1] == streams[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True])
def test_hybrid_lane_reuse_isolation(dtype, paged):
    """Re-admitting a lane must not leak the previous request's state:
    request B through a reused lane equals B served solo in a fresh
    engine (the reference's test of the same name, for hymba), and so
    do the lane's SSM state and the K/V slots it reads right after B's
    admission, bit for bit."""
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              dtype=dtype)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(8)
    pa, pb = (rng.integers(0, cfg.vocab_size, n).astype(np.int32)
              for n in (40, 7))
    kw = dict(n_lanes=1, max_len=64, dispatch_n=4, device="cpu",
              paged=paged, page_size=PAGE)

    def admit_b(eng):
        req = Request(uid=1, prompt=pb.copy(), max_new_tokens=4)
        assert eng.admit(req)
        state = {k: eng.cache[k].clone() for k in ("ssm_h", "ssm_conv")}
        if paged:
            pages = torch.tensor(eng.lane_pages(0)[:1])
            state["k"] = eng.cache["k_pages"][:, pages, :, :7].clone()
        else:
            state["k"] = eng.cache["k"][:, 0, :, :7].clone()
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


@pytest.mark.parametrize("paged", [False, True])
def test_admitted_kv_is_the_streamed_kv(setup, paged):
    """After admitting a prompt longer than the window, the lane holds
    the K/V of streaming the prompt through the decode step from length
    0 (as the reference's ``_ssm_prefill_scan`` leaves it), not the
    prefill's scatter: its ring slots equal, bit for bit, those of the
    same tokens through ``lm_decode_step`` on a fresh batch-1 cache, and
    so do the SSM state and the first token's logits."""
    _, _, cfg, params, prompts = setup
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    eng = ServeEngine(cfg, params, n_lanes=N_LANES, max_len=MAX_LEN,
                      device="cpu", **kw)
    logits = []
    first = eng._set_first_token
    eng._set_first_token = lambda lg, lane: (logits.append(lg.clone()),
                                             first(lg, lane))
    prompt = prompts[1]                                 # 40 > window 32
    req = Request(uid=0, prompt=prompt.copy(), max_new_tokens=4)
    assert eng.admit(req)
    lane = eng.lane_req.index(req)
    take = cfg.sliding_window
    model = build_model(cfg)
    if paged:
        cache = model.init_paged_cache(1, MAX_LEN, page_size=PAGE,
                                       device=CPU)
        cache["block_tables"] = torch.arange(take // PAGE,
                                             dtype=torch.int32)[None]
    else:
        cache = model.init_cache(1, MAX_LEN, device=CPU)
    for t in range(len(prompt)):
        out, cache = model.decode_step(params, cache,
                                       torch.from_numpy(prompt[t:t + 1]))
    assert torch.equal(logits[-1], out)
    for key in ("ssm_h", "ssm_conv"):
        assert torch.equal(eng.cache[key][:, lane], cache[key][:, 0]), key
    for key in ("k", "v"):
        if paged:
            pages = torch.tensor(eng.lane_pages(lane))
            got = eng.cache[key + "_pages"][:, pages]
            want = cache[key + "_pages"]
        else:
            got = eng.cache[key][:, lane, :, :take]
            want = cache[key][:, 0]
        assert torch.equal(got, want), key


def test_hybrid_cache_layout():
    cfg = get_config("hymba-1.5b", smoke=True)        # bfloat16
    model = build_model(cfg)
    nh = 2 * cfg.d_model // cfg.ssm.head_dim
    dense = model.init_cache(3, 64, device=CPU)
    paged = model.init_paged_cache(3, 64, page_size=8, device=CPU)
    assert sorted(dense) == ["k", "len", "ssm_conv", "ssm_h", "v"]
    assert sorted(paged) == ["block_tables", "k_pages", "len", "ssm_conv",
                             "ssm_h", "v_pages"]
    win = cfg.sliding_window
    assert tuple(dense["k"].shape) == (cfg.n_layers, 3, cfg.n_kv_heads, win,
                                       cfg.hd)
    assert tuple(paged["block_tables"].shape) == (3, win // 8)
    for cache in (dense, paged):
        assert tuple(cache["ssm_h"].shape) == (
            cfg.n_layers, 3, nh, cfg.ssm.state_dim, cfg.ssm.head_dim)
        assert cache["ssm_h"].dtype == torch.float32
    q8 = build_model(dataclasses.replace(cfg, kv_quant="int8"))
    cache = q8.init_paged_cache(3, 64, page_size=8, device=CPU)
    assert cache["k_pages"].dtype == torch.int8
    assert tuple(cache["k_scale_pages"].shape) == \
        tuple(cache["k_pages"].shape[:-1]) + (1,)


@pytest.mark.parametrize("paged", [False, True])
def test_launcher_serves_hymba(paged, capsys):
    argv = ["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
            "--requests", "3", "--prompt-len", "40", "--gen", "4",
            "--lanes", "2"]
    serve_launcher.main(argv + (["--paged", "--page-size", "8"] if paged
                                else []))
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "'ssm_prefill_compiles': 1" in out
    assert "capability-model prediction" in out
