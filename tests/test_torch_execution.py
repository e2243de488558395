"""The execution replay (``repro_torch.fleet``) and the calibration gate
(``repro_torch.obs.calibration``) against the reference's.

* seeded traces (Poisson, bursty, diurnal, constant, the multi-model
  and shared-prefix overlays) and ``FaultPlan.seeded`` / ``flap`` / ``+``
  are the reference's, field for field;
* on float32 SMOKE qwen2.5-1.5b (and olmo-1b for the multi-model
  replay), the reference's weights carried over: ``run_trace_on_engine``
  (fixed-lane, paged, with preemption churn), ``validate_preemption_
  exactness``, ``run_trace_with_faults`` (a crash, checkpoints and
  transient dispatches, by plan or by knobs; ``retry_attempts`` carried
  into the surviving engine), ``validate_recovery_exactness`` and the
  multi-model replay and validator give the reference's results; the
  crashed node's flight ring is dumped;
* ``predict_replay`` and ``calibrate_replay`` give the reference's
  numbers on the same replay, and a mis-modelled dispatch size or page
  geometry fails the gate.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import fleet as jax_fleet  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.fleet import execution as jax_execution  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.obs import calibration as jax_calibration  # noqa: E402
from repro_torch import fleet  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fleet import FaultEvent, FaultPlan, LengthDist  # noqa: E402
from repro_torch.obs import (DEFAULT_LOG, FlightRecorder,  # noqa: E402
                             MetricsRegistry, SpanTracer, calibrate_replay,
                             fit_linear, predict_replay)
from repro_torch.serving import kv_page_bytes, params_nbytes  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.faults]
torch.set_num_threads(2)

CPU = torch.device("cpu")
ORACLE_TRACE_KW = dict(seed=3, prompt=LengthDist(12, cv=0.3),
                       gen=LengthDist(14, cv=0.4))
ORACLE_KW = dict(n_lanes=2, max_len=32, dispatch_n=4, page_size=8, seed=5)


@pytest.fixture(scope="module")
def models():
    """{"a": qwen2.5-1.5b, "b": olmo-1b}: each (jcfg, jparams, cfg,
    params), float32 SMOKE, the reference's weights carried over."""
    out = {}
    for seed, (mid, arch) in enumerate((("a", "qwen2.5-1.5b"),
                                        ("b", "olmo-1b"))):
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                   dtype="float32")
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        jparams = jax_init_lm(jax.random.PRNGKey(seed), jcfg)
        out[mid] = (jcfg, jparams, cfg,
                    params_from_jax(jax.device_get(jparams), cfg, CPU))
    return out


def _as_tuples(trace):
    return [dataclasses.astuple(r) for r in trace]


def _ref_dist(d):
    return jax_fleet.LengthDist(d.mean, d.cv, d.min_len, d.max_len)


TRACES = {
    "poisson": lambda m, kw: m.poisson_trace(
        3.0, 20.0, seed=kw["seed"], prompt=kw["prompt"], gen=kw["gen"]),
    "bursty": lambda m, kw: m.bursty_trace(
        8.0, 30.0, seed=kw["seed"], mean_on_s=4.0, mean_off_s=6.0,
        prompt=kw["prompt"], gen=kw["gen"]),
    "diurnal": lambda m, kw: m.diurnal_trace(
        1.0, 5.0, 40.0, seed=kw["seed"], period_s=20.0,
        prompt=kw["prompt"], gen=kw["gen"]),
    "constant": lambda m, kw: m.constant_trace(2.0, 5.0, 64, 16),
    "multimodel": lambda m, kw: m.multimodel_trace(
        m.poisson_trace(3.0, 20.0, seed=kw["seed"], prompt=kw["prompt"]),
        {"a": 2, "b": 1}, seed=kw["seed"] + 1),
    "shared_prefix": lambda m, kw: m.shared_prefix_trace(
        m.poisson_trace(3.0, 20.0, seed=kw["seed"], prompt=kw["prompt"]),
        prefix_len=24, fanout=3, seed=kw["seed"] + 1),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", sorted(TRACES))
def test_seeded_traces_equal_reference(kind, seed):
    prompt, gen = LengthDist(40, cv=0.5), LengthDist(12, cv=0.3)
    ours = TRACES[kind](fleet, dict(seed=seed, prompt=prompt, gen=gen))
    ref = TRACES[kind](jax_fleet, dict(seed=seed, prompt=_ref_dist(prompt),
                                       gen=_ref_dist(gen)))
    assert len(ours) > 0
    assert _as_tuples(ours) == _as_tuples(ref)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_fault_plans_equal_reference(seed):
    kw = dict(n_nodes=4, horizon_s=60.0, n_crashes=2, n_transients=3)
    ours = FaultPlan.seeded(seed, **kw)
    ref = jax_fleet.FaultPlan.seeded(seed, **kw)
    assert [dataclasses.astuple(e) for e in ours.events] == \
        [dataclasses.astuple(e) for e in ref.events]
    flap = FaultPlan.flap("n1", 2.0, 4.0, 3)
    jflap = jax_fleet.FaultPlan.flap("n1", 2.0, 4.0, 3)
    merged, jmerged = ours + flap, ref + jflap
    assert [dataclasses.astuple(e) for e in merged.events] == \
        [dataclasses.astuple(e) for e in jmerged.events]
    assert [dataclasses.astuple(e) for e in merged.sim_events()] == \
        [dataclasses.astuple(e) for e in jmerged.sim_events()]
    replay = FaultPlan((FaultEvent("transient", at_dispatch=3),
                        FaultEvent("crash", at_dispatch=7),
                        FaultEvent("crash", at_dispatch=5)))
    assert replay.crash_dispatch() == 5
    assert replay.transient_dispatches() == [3]
    assert fleet.FAULT_KINDS == jax_fleet.FAULT_KINDS
    for bad in (dict(kind="melt", at_s=1.0), dict(kind="crash"),
                dict(kind="derate", at_s=1.0, factor=0.5),
                dict(kind="transient", at_s=1.0)):
        with pytest.raises(ValueError) as ours_e:
            FaultEvent(**bad)
        with pytest.raises(ValueError) as ref_e:
            jax_fleet.FaultEvent(**bad)
        assert str(ours_e.value) == str(ref_e.value)


def test_fault_injector_resolves_and_counts():
    class Node:
        def __init__(self, node_id, failed=False):
            self.node_id, self.failed = node_id, failed

    reg = MetricsRegistry()
    inj = fleet.FaultInjector(FaultPlan(), registry=reg)
    nodes = [Node("n2"), Node("n0", failed=True), Node("n1")]
    assert inj.resolve(FaultEvent("crash", node=3, at_s=1.0),
                       nodes).node_id == "n2"
    assert inj.resolve(FaultEvent("crash", node="n0", at_s=1.0),
                       nodes) is None
    inj.count("crash")
    inj.count_retry(2)
    inj.count_hedge()
    inj.count_lost()
    assert (reg["fleet.faults.crashes"].value,
            reg["fleet.retry.attempts"].value,
            reg["fleet.retry.hedges"].value,
            reg["fleet.faults.requests_lost"].value) == (1, 2, 1, 1)
    pol = fleet.RecoveryPolicy()
    assert pol.checkpoint_interval_s == 5.0
    assert isinstance(pol.retry, fleet.RetryPolicy)


def _oracle_trace(module):
    kw = dict(ORACLE_TRACE_KW)
    if module is jax_fleet:
        kw["prompt"], kw["gen"] = _ref_dist(kw["prompt"]), _ref_dist(kw["gen"])
    return module.poisson_trace(2.0, 6.0, **kw)


def _short_trace(module):
    return [module.FleetRequest(uid=i, arrival_s=0.1 * i, prompt_len=6 + i,
                                gen_len=8) for i in range(4)]


@pytest.mark.parametrize("mode", ["fixed-lane", "paged", "preempt"])
def test_run_trace_on_engine_matches_reference(models, mode):
    jcfg, jparams, cfg, params = models["a"]
    kw = dict(ORACLE_KW, paged=mode != "fixed-lane")
    if mode == "preempt":
        kw["preempt_every"] = 2
    ours = fleet.run_trace_on_engine(_oracle_trace(fleet), cfg, params,
                                     device="cpu", **kw)
    ref = jax_execution.run_trace_on_engine(_oracle_trace(jax_fleet), jcfg,
                                            jparams, **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.gen_tokens > 0
    if mode == "preempt":
        assert ours.preemptions == ours.restores > 0
    reqs = fleet.trace_requests(_oracle_trace(fleet), cfg.vocab_size, 5)
    jreqs = jax_execution.trace_requests(_oracle_trace(jax_fleet),
                                         jcfg.vocab_size, 5)
    assert [(r.uid, r.prompt.tolist()) for r in reqs] == \
        [(r.uid, r.prompt.tolist()) for r in jreqs]


def test_validate_preemption_exactness_matches_reference(models):
    jcfg, jparams, cfg, params = models["a"]
    DEFAULT_LOG.clear()
    ours = fleet.validate_preemption_exactness(
        _short_trace(fleet), cfg, params, preempt_every=1, device="cpu",
        **ORACLE_KW)
    ref = jax_execution.validate_preemption_exactness(
        _short_trace(jax_fleet), jcfg, jparams, preempt_every=1,
        **ORACLE_KW)
    assert ours == ref
    assert ours["resume_exact"] and ours["preemptions"] > 0
    (ev,) = DEFAULT_LOG.records("validate.preemption_exactness")
    assert ev.fields["n_mismatches"] == 0


def _fault_result(res):
    d = dataclasses.asdict(res)
    d.pop("flight_dumps")
    return d


@pytest.mark.parametrize("via", ["knobs", "plan"])
def test_run_trace_with_faults_matches_reference(models, via, tmp_path):
    """A crash at dispatch 4 with checkpoints every 2 and a transient at
    dispatch 1: the same streams, checkpointed and replayed uids and
    counters as the reference; retries land in the survivor's
    ``retry_attempts``; the dying node's flight ring is dumped."""
    jcfg, jparams, cfg, params = models["a"]
    if via == "plan":
        kw = dict(plan=FaultPlan((FaultEvent("transient", at_dispatch=1),
                                  FaultEvent("crash", at_dispatch=4))))
        jkw = dict(plan=jax_fleet.FaultPlan((
            jax_fleet.FaultEvent("transient", at_dispatch=1),
            jax_fleet.FaultEvent("crash", at_dispatch=4))))
    else:
        kw = jkw = dict(crash_at_dispatch=4, transient_dispatches=(1,))
    reg = MetricsRegistry()
    ours = fleet.run_trace_with_faults(
        _short_trace(fleet), cfg, params, checkpoint_every=2,
        registry=reg, flight_dir=str(tmp_path), device="cpu",
        **dict(ORACLE_KW, **kw))
    ref = jax_execution.run_trace_with_faults(
        _short_trace(jax_fleet), jcfg, jparams, checkpoint_every=2,
        **dict(ORACLE_KW, **jkw))
    assert _fault_result(ours) == _fault_result(ref)
    assert ours.crashes == 1 and ours.transients == 1
    assert ours.retry_attempts >= 1 + len(ours.checkpointed_uids
                                          + ours.replayed_uids)
    assert reg["node1.retry.attempts"].value == ours.retry_attempts
    assert ours.flight_dumps == (str(tmp_path / "flight_node0.jsonl"),)
    header, records = FlightRecorder.load(ours.flight_dumps[0])
    assert header["reason"] == "crash at dispatch 4" and records


def test_validate_recovery_exactness_matches_reference(models):
    jcfg, jparams, cfg, params = models["a"]
    kw = dict(crash_at_dispatch=10, checkpoint_every=3,
              transient_dispatches=(2,), **ORACLE_KW)
    DEFAULT_LOG.clear()
    ours = fleet.validate_recovery_exactness(_oracle_trace(fleet), cfg,
                                             params, device="cpu", **kw)
    ref = jax_execution.validate_recovery_exactness(
        _oracle_trace(jax_fleet), jcfg, jparams, **kw)
    assert ours == ref
    assert ours["resume_exact"] and ours["replay_exact"]
    assert ours["counts_match"] and ours["crashes"] == 1
    assert ours["recovered_lanes"] >= 1 and ours["replayed_from_prompt"] >= 1
    (ev,) = DEFAULT_LOG.records("validate.recovery_exactness")
    assert ev.fields["resume_exact"] is True


def _mm_models(models, side):
    if side == "port":
        return {mid: (m[2], m[3]) for mid, m in sorted(models.items())}
    return {mid: (m[0], m[1]) for mid, m in sorted(models.items())}


def _mm_trace(module):
    return [module.FleetRequest(uid=i, arrival_s=0.1 * i,
                                prompt_len=4 + i % 3, gen_len=5,
                                model_id="a" if i % 2 == 0 else "b")
            for i in range(6)]


@pytest.mark.parametrize("budget", ["dense", "tight"])
def test_multimodel_replay_matches_reference(models, budget):
    kw = dict(n_lanes=2, max_len=32, dispatch_n=4, page_size=8, seed=2)
    dense = fleet.dense_hbm_bytes(_mm_models(models, "port"), n_lanes=2,
                                  max_len=32, page_size=8)
    assert dense == jax_execution.dense_hbm_bytes(
        _mm_models(models, "ref"), n_lanes=2, max_len=32, page_size=8)
    # tight: both weights, one full context each and two pages of a
    (ca, pa), (cb, pb) = _mm_models(models, "port").values()
    bt = 32 // 8
    hbm = None if budget == "dense" else (
        params_nbytes(pa) + params_nbytes(pb)
        + (bt + 3) * kv_page_bytes(ca, 8) + (bt + 1) * kv_page_bytes(cb, 8))
    ours = fleet.run_multimodel_trace_on_engine(
        _mm_trace(fleet), _mm_models(models, "port"), hbm_bytes=hbm,
        device="cpu", **kw)
    ref = jax_execution.run_multimodel_trace_on_engine(
        _mm_trace(jax_fleet), _mm_models(models, "ref"), hbm_bytes=hbm,
        **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.model_swaps >= 2
    if budget == "tight":
        assert ours.kv_pages_shrunk + ours.weight_evictions > 0


def test_validate_multimodel_exactness_matches_reference(models):
    kw = dict(n_lanes=2, max_len=32, dispatch_n=4, page_size=8)
    DEFAULT_LOG.clear()
    ours = fleet.validate_multimodel_exactness(
        _mm_trace(fleet), _mm_models(models, "port"), device="cpu", **kw)
    ref = jax_execution.validate_multimodel_exactness(
        _mm_trace(jax_fleet), _mm_models(models, "ref"), **kw)
    assert ours == ref and ours["exact"]
    (ev,) = DEFAULT_LOG.records("validate.multimodel_exactness")
    assert ev.fields["model_swaps"] == ours["model_swaps"]


def test_calibration_matches_reference(models):
    """predict_replay and calibrate_replay: the reference's numbers on
    the same replay, a perfect fit of the real paged replay, and a gate
    that fails a mis-modelled dispatch size or page geometry."""
    _, _, cfg, params = models["a"]
    trace = [fleet.FleetRequest(uid=i, arrival_s=0.05 * i,
                                prompt_len=3 + i % 4, gen_len=2 + i % 5)
             for i in range(6)]
    jtrace = [jax_fleet.FleetRequest(**dataclasses.asdict(r))
              for r in trace]
    kw = dict(n_lanes=2, max_len=64, dispatch_n=4, paged=True, page_size=8)
    reg = MetricsRegistry()
    tr = SpanTracer(registry=reg)
    real = fleet.run_trace_on_engine(trace, cfg, params, tracer=tr,
                                     registry=reg, device="cpu", **kw)
    sim = predict_replay(trace, **kw)
    assert sim.as_dict() == jax_calibration.predict_replay(
        jtrace, **kw).as_dict()
    rep = calibrate_replay(real, sim, spans=tr.spans)
    jrep = jax_calibration.calibrate_replay(
        real, jax_calibration.predict_replay(jtrace, **kw))
    assert rep.ok and rep.max_rel_err == 0.0
    assert rep.metrics == jrep.metrics and rep.ok == jrep.ok
    assert rep.fitted["n_spans"] == real.decode_dispatches
    for pert in (dict(kw, dispatch_n=1), dict(kw, page_size=2)):
        bad = calibrate_replay(real, predict_replay(trace, **pert))
        jbad = jax_calibration.calibrate_replay(
            real, jax_calibration.predict_replay(jtrace, **pert))
        assert not bad.ok and bad.metrics == jbad.metrics
    for fixed in (False, True):
        p = predict_replay(trace, **dict(kw, paged=fixed, n_pages=6))
        jp = jax_calibration.predict_replay(jtrace,
                                            **dict(kw, paged=fixed,
                                                   n_pages=6))
        assert p.as_dict() == jp.as_dict()
    xs, ys = [1.0, 2.0, 4.0, 8.0], [0.5, 0.7, 1.1, 1.9]
    assert fit_linear(xs, ys) == jax_calibration.fit_linear(xs, ys)
