"""The port's serving engine with the observability and resilience stack
on, held against the reference's engine with the same stack.

On the reference tests' paged SMOKE setup (``n_lanes=2, max_len=64,
dispatch_n=4, paged=True, page_size=8, n_pages=10``, qwen2.5 SMOKE in
float32), each engine with a tracer, a shared registry, a flight
recorder, a lenient SLO controller over a degradation ladder and
``sanitize=True``, both on an injected counting clock (never the wall
clock):

* streams, all 23 ``STATS_SCHEMA`` counters, the sequence of spans and
  instants (kind, name, track, args; times left out) and the
  sanitizer's page-op log are equal, and every request's timeline is
  complete; so with prefix sharing (hits, copy-on-write, tail streams);
* tracing on and off give the same streams and compile counters, on
  both layouts, and one ``decode.dispatch`` span per counted dispatch;
* the ladder under a tight pool makes the reference's transitions and
  sheds, and every stream equals the reference's and the serve without
  a ladder's;
* a sanitized evict/restore is clean; with ``sanitize`` off there is no
  sanitizer and no pool monitor;
* an ``InvariantError`` forced inside ``decode_n`` leaves a flight dump
  whose header names the op; another error leaves none.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.serving import DegradationLadder as JaxLadder  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import schema as obs_schema  # noqa: E402
from repro_torch.analysis.invariants import invariant  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import (STATS_KEYS, DegradationLadder,  # noqa: E402
                                 Request, ServeEngine)

pytestmark = [pytest.mark.torch_port, pytest.mark.obs]
torch.set_num_threads(2)

CPU = torch.device("cpu")
ENGINE_KW = dict(n_lanes=2, max_len=64, dispatch_n=4, paged=True,
                 page_size=8, n_pages=10)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, params_from_jax(jax.device_get(jparams), cfg,
                                               CPU)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _family(cfg, head_len=12, tails=(0, 6, 9), seed=11):
    """Prompts sharing a head (by default of one full page and half of
    another, the whole first prompt: the others split its partial page
    on write)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, head_len).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, cfg.vocab_size, t)
                            .astype(np.int32)]) for t in tails]


def _reqs(cls, prompts, max_new, priority=False):
    return [cls(uid=i, prompt=p.copy(), max_new_tokens=max_new,
                priority=i % 2 if priority else 0)
            for i, p in enumerate(prompts)]


def _counting_clock():
    """A clock that advances one millisecond a read: deterministic, and
    every interval it measures is positive."""
    ticks = itertools.count(1)
    return lambda: next(ticks) * 1e-3


def _stack(pkg, ladder_cls, name="serve"):
    """The full stack of one package on a fresh counting clock, as
    engine keyword arguments (the SLO objective is lenient: the ladder
    must stay at level 0)."""
    clock = _counting_clock()
    reg = pkg.MetricsRegistry()
    tracer = pkg.SpanTracer(enabled=True, clock=clock, registry=reg)
    mon = pkg.BurnRateMonitor(pkg.SLOObjective(ttft_s=60.0, tpot_s=1.0),
                              registry=reg)
    ctl = pkg.SLOController(mon, ladder_cls())
    flight = pkg.FlightRecorder(name=name, capacity=1 << 14)
    return dict(tracer=tracer, registry=reg, flight=flight, slo=ctl,
                clock=clock, sanitize=True)


def _record_seq(flight):
    """The flight ring's spans and instants in the order they were
    recorded, times left out; tuples (the ``uids`` arg) as lists."""
    out = []
    for r in flight.records():
        if r["kind"] not in ("span", "instant"):
            continue
        args = {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in r["args"].items()}
        out.append((r["kind"], r["name"], r["track"], args))
    return out


def _page_log(log):
    return [(e.name, dict(e.fields)) for e in log.records()]


def _serve_pair(model, prompts, max_new, tmp_path, monkeypatch, **kw):
    """(reference engine, its requests, port engine, its requests), both
    with the full stack and a page-op log on their sanitizer."""
    jcfg, jparams, cfg, params = model
    monkeypatch.chdir(tmp_path)            # a flight dump would land here
    out = []
    for eng_cls, req_cls, pkg, ladder_cls, c, p, extra in (
            (JaxServeEngine, JaxRequest, jobs, JaxLadder, jcfg, jparams, {}),
            (ServeEngine, Request, obs, DegradationLadder, cfg, params,
             {"device": "cpu"})):
        eng = eng_cls(c, p, **_stack(pkg, ladder_cls), **kw, **extra)
        eng._sanitizer.log = pkg.EventLog(clock=lambda: 0.0)
        reqs = _reqs(req_cls, prompts, max_new)
        eng.run(reqs)
        out += [eng, reqs]
    return out


@pytest.fixture(scope="module")
def full_stack(model, tmp_path_factory):
    """The reference's and the port's full-stack serve of four prompts
    (one blocked for pages at first), each run once for the module."""
    mp = pytest.MonkeyPatch()
    try:
        yield _serve_pair(model, _prompts(model[2], [40, 30, 5, 17]), 6,
                          tmp_path_factory.mktemp("flight"), mp,
                          **ENGINE_KW)
    finally:
        mp.undo()


def test_full_stack_streams_and_counters_match_reference(model, full_stack):
    jeng, jreqs, teng, treqs = full_stack
    _, _, cfg, params = model
    assert len(STATS_KEYS) == 23
    assert set(STATS_KEYS) == set(JaxServeEngine.STATS_SCHEMA)
    assert ServeEngine.STATS_SCHEMA == JaxServeEngine.STATS_SCHEMA
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["kv_admit_blocked"] > 0
    assert teng.registry["serve.decode.dispatches"].value == \
        teng.stats["decode_dispatches"]
    # the stack changes no stream
    plain = _reqs(Request, _prompts(cfg, [40, 30, 5, 17]), 6)
    ServeEngine(cfg, params, device="cpu", **ENGINE_KW).run(plain)
    assert [r.generated for r in treqs] == [r.generated for r in plain]
    assert teng.slo.ladder.level == 0 and not teng.slo.escalated


def test_full_stack_span_sequence_matches_reference(full_stack):
    jeng, _, teng, _ = full_stack
    jseq, tseq = _record_seq(jeng.flight), _record_seq(teng.flight)
    assert tseq == jseq
    names = {name for _, name, _, _ in tseq}
    assert {"admit", "admit.blocked", "prefill.bucket", "decode.dispatch",
            "first_token", "retire"} <= names
    assert names <= set(obs_schema.SPAN_NAMES) | set(
        obs_schema.INSTANT_NAMES)
    assert teng.tracer.check_well_nested()
    n_disp = teng.stats["decode_dispatches"]
    assert len(teng.tracer.spans_named("decode.dispatch")) == n_disp
    assert teng.registry["span.decode.dispatch.seconds"].count == n_disp


def test_full_stack_page_op_log_matches_reference(full_stack):
    jeng, _, teng, _ = full_stack
    tlog, jlog = _page_log(teng._sanitizer.log), _page_log(jeng._sanitizer.log)
    assert tlog == jlog
    ops = {name for name, _ in tlog}
    assert {"page.reserve", "page.alloc", "page.map", "page.write",
            "page.free", "page.unreserve"} <= ops
    assert teng._sanitizer.clean and teng.pool.monitor is teng._sanitizer
    teng.pool.check()
    teng._sanitizer.crosscheck(teng.pool)
    assert teng._sanitizer.clean


def test_full_stack_timelines_pool_gauges_and_slo(full_stack):
    _, _, teng, treqs = full_stack
    tls = obs.request_timelines(teng.tracer)
    assert sorted(tls) == [r.uid for r in treqs]
    for uid, tl in sorted(tls.items()):
        assert tl.complete, (uid, tl.gaps())
        assert tl.ttft_s is not None and tl.ttft_s > 0
        assert tl.tpot_series
    assert teng._admit_t == {}
    assert len(teng.slo.monitor.short) > 0
    reg = teng.registry
    assert reg["serve.pool.pages.in_use"].value == 0
    assert reg["serve.pool.pages.allocs"].value == \
        reg["serve.pool.pages.frees"].value > 0
    assert reg["serve.pool.pages.disabled"].value == 0
    assert reg["serve.pool.pages.hwm"].value == teng.stats["kv_pages_hwm"]
    assert any(r["kind"] == "span" and r["name"] == "decode.dispatch"
               for r in teng.flight.records())
    assert teng.flight.n_dumps == 0


def test_prefix_sharing_full_stack_matches_reference(model, tmp_path,
                                                     monkeypatch):
    jeng, jreqs, teng, treqs = _serve_pair(
        model, _family(model[2]), 6, tmp_path, monkeypatch,
        prefix_sharing=True, **dict(ENGINE_KW, n_pages=12))
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["prefix_hits"] >= 1
    assert teng.stats["prefix_cow_copies"] >= 1
    tseq = _record_seq(teng.flight)
    assert tseq == _record_seq(jeng.flight)
    assert {"prefix.hit", "prefix.cow", "prefix.tail_prefill"} <= {
        name for _, name, _, _ in tseq}
    assert _page_log(teng._sanitizer.log) == _page_log(jeng._sanitizer.log)
    assert teng.registry["serve.prefix.cached_pages"].value == \
        teng.prefix_cache.n_pages > 0
    teng.prefix_cache.flush()
    teng.pool.check()
    teng._sanitizer.crosscheck(teng.pool)
    assert teng._sanitizer.clean and teng.pool.n_in_use == 0


@pytest.mark.parametrize("paged", [False, True])
def test_tracing_is_exactness_neutral(model, paged):
    _, _, cfg, params = model
    prompts = _prompts(cfg, [40, 30, 5, 17])
    kw = dict(ENGINE_KW, paged=paged)
    plain = _reqs(Request, prompts, 6)
    off = ServeEngine(cfg, params, device="cpu", **kw)
    off.run(plain)
    reg = obs.MetricsRegistry()
    tracer = obs.SpanTracer(enabled=True, clock=_counting_clock(),
                            registry=reg)
    traced = _reqs(Request, prompts, 6)
    on = ServeEngine(cfg, params, device="cpu", tracer=tracer, registry=reg,
                     **kw)
    on.run(traced)
    assert [r.generated for r in traced] == [r.generated for r in plain]
    for k in ("decode_compiles", "prefill_compiles", "decode_dispatches"):
        assert on.stats[k] == off.stats[k], k
    assert len(tracer.spans_named("decode.dispatch")) == \
        on.stats["decode_dispatches"]
    assert on._sanitizer is None
    if not paged:
        assert on.pool is None and "serve.pool.pages.free" not in reg
    # the bench reset idiom writes through the view
    on.stats = {k: 0 for k in on.stats}
    assert reg["serve.decode.dispatches"].value == 0


def test_ladder_matches_reference_and_plain(model):
    """The reference's ladder case: a tight pool escalates the ladder
    to ``evict`` and sheds lanes; transitions, sheds and streams equal
    the reference's, and the streams the serve without a ladder's."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts(cfg, [6] * 6)
    kw = dict(n_lanes=4, max_len=32, dispatch_n=4, paged=True, page_size=8,
              n_pages=10)
    lkw = dict(page_pressure=0.5, trip_after=1, cooldown=50)
    jladder = JaxLadder(**lkw)
    jeng = JaxServeEngine(jcfg, jparams, ladder=jladder, **kw)
    jreqs = _reqs(JaxRequest, prompts, 12, priority=True)
    jeng.run(jreqs)
    ladder = DegradationLadder(**lkw)
    tracer = obs.SpanTracer(enabled=True, clock=_counting_clock())
    teng = ServeEngine(cfg, params, ladder=ladder, tracer=tracer,
                       device="cpu", **kw)
    treqs = _reqs(Request, prompts, 12, priority=True)
    teng.run(treqs)
    plain = _reqs(Request, prompts, 12, priority=True)
    ServeEngine(cfg, params, device="cpu", **kw).run(plain)
    assert ladder.transitions == jladder.transitions
    assert 3 in [to for _, to, _ in ladder.transitions]     # evict rung
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["degrade_sheds"] > 0
    assert teng.stats["degrade_transitions"] == len(ladder.transitions)
    assert teng.stats["restores"] == teng.stats["preemptions"] == \
        teng.stats["degrade_sheds"]
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.generated for r in treqs] == [r.generated for r in plain]
    sheds = tracer.instants_named("degrade.shed")
    assert len(sheds) == teng.stats["degrade_sheds"]
    assert all(e.args["level"] == "evict" for e in sheds)
    assert all(tl.complete for tl in obs.request_timelines(tracer).values())
    teng.pool.check()
    assert teng.pool.n_in_use == 0


def test_sanitized_evict_restore_clean(model):
    _, _, cfg, params = model
    donor, consumer = _family(cfg, head_len=16, tails=(4, 6))
    kw = dict(n_lanes=2, max_len=32, dispatch_n=4, paged=True, page_size=8,
              rng_seed=7)
    eng = ServeEngine(cfg, params, prefix_sharing=True, sanitize=True,
                      device="cpu", **kw)
    eng.run([Request(uid=0, prompt=donor.copy(), max_new_tokens=10)])
    creq = Request(uid=1, prompt=consumer.copy(), max_new_tokens=10)
    assert eng.admit(creq)
    assert eng.stats["prefix_hits"] == 1
    eng.decode_n()
    lane = next(i for i, r in enumerate(eng.lane_req) if r is creq)
    ckpt = eng.evict(lane)
    assert eng.restore(ckpt)
    while eng.live_lanes():
        eng.decode_n()
    san = eng._sanitizer
    assert san.clean and san.ops_seen > 0
    eng.prefix_cache.flush()
    eng.pool.check()
    san.crosscheck(eng.pool)
    assert san.clean and eng.pool.n_in_use == 0
    # the same lane's stream as the unsanitized, uninterrupted serve
    ref = ServeEngine(cfg, params, prefix_sharing=True, device="cpu", **kw)
    reqs = [Request(uid=0, prompt=donor.copy(), max_new_tokens=10)]
    ref.run(reqs)
    ref_c = Request(uid=1, prompt=consumer.copy(), max_new_tokens=10)
    ref.run([ref_c])
    assert creq.generated == ref_c.generated


def test_sanitize_off_is_one_attr_check(model):
    _, _, cfg, params = model
    eng = ServeEngine(cfg, params, device="cpu", **ENGINE_KW)
    assert eng._sanitizer is None and eng.pool.monitor is None
    assert eng.clock is eng.tracer.clock and not eng.tracer.enabled


def test_forced_invariant_error_in_decode_dumps_flight(model, tmp_path,
                                                       monkeypatch):
    _, _, cfg, params = model
    monkeypatch.chdir(tmp_path)
    tracer = obs.SpanTracer(enabled=True, clock=_counting_clock())
    flight = obs.FlightRecorder(name="serve")
    eng = ServeEngine(cfg, params, tracer=tracer, flight=flight,
                      device="cpu", **ENGINE_KW)
    assert eng.admit(Request(uid=0, prompt=_prompts(cfg, [9])[0],
                             max_new_tokens=8))
    eng.decode_n()
    assert flight.n_dumps == 0

    def broken(n):
        invariant(False, "forced fault", n=n)

    monkeypatch.setattr(eng, "map_dispatch_pages", broken)
    with pytest.raises(AssertionError, match="forced fault"):
        eng.decode_n()
    assert flight.dump_paths == ["flight_serve.jsonl"]
    header, records = obs.FlightRecorder.load(tmp_path / "flight_serve.jsonl")
    assert header["op"] == "decode.dispatch"
    assert "InvariantError" in header["reason"]
    assert records[-1]["kind"] == "metrics"
    assert records[-1]["values"]["serve.decode.dispatches"] == 1
    assert any(r.get("name") == "decode.dispatch" for r in records)

    def other(n):
        raise ValueError("not a lifecycle fault")

    monkeypatch.setattr(eng, "map_dispatch_pages", other)
    with pytest.raises(ValueError):
        eng.decode_n()
    assert flight.n_dumps == 1
