"""The fleet simulator (``repro_torch.fleet``: node, router, sim,
autoscale), the steady-state planner (``repro_torch.serving.
disaggregation``) and the token-accounting check against the
reference's.

Every scenario the reference's own tests run on its simulator --
``tests/test_fleet_sim.py`` (the mixed plan, the planner's steady
state, the homogeneous baseline, the KV handoff, the routers, the
autoscaler), the fleet cases of ``tests/test_preemption.py`` (page-
exhaustion migration, the straggler policy, ``SimNode`` page
arithmetic) and ``tests/test_modelpool.py`` (affinity routing, the
multi-model mix, ``SimNode`` swaps, the preemption-aware router), and
``tests/test_obs.py::test_fleet_sim_spans_and_gauges`` -- is built once
from each package with the same seeds; ``FleetReport.metrics()`` and
the event lists must be equal (``==``, bit for bit), as must the
traces, the spans and the gauges.  ``plan_fleet`` and
``homogeneous_baseline`` are equal field by field, and
``validate_token_accounting`` on the reference's SMOKE case returns the
reference's dict.
"""

import dataclasses
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.device_profile as jax_dp  # noqa: E402
import repro.core.perf_model as jax_pm  # noqa: E402
import repro.fleet as jax_fleet  # noqa: E402
import repro.fleet.workload as jax_workload  # noqa: E402
import repro.obs as jax_obs  # noqa: E402
import repro.serving as jax_serving  # noqa: E402
import repro_torch.core.device_profile as dp  # noqa: E402
import repro_torch.core.perf_model as pm  # noqa: E402
import repro_torch.fleet as fleet  # noqa: E402
import repro_torch.fleet.workload as workload  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
import repro_torch.serving as serving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

pytestmark = [pytest.mark.torch_port]

PKGS = {
    "reference": SimpleNamespace(fleet=jax_fleet, workload=jax_workload,
                                 serving=jax_serving, dp=jax_dp, pm=jax_pm,
                                 obs=jax_obs),
    "port": SimpleNamespace(fleet=fleet, workload=workload, serving=serving,
                            dp=dp, pm=pm, obs=obs),
}
MIXED_POOLS = {"a100-40g": 2, "cmp-170hx-nofma": 8}


def _wl(k):
    return k.serving.Workload(prompt_len=512, gen_len=128, fmt="q8_0")


def _report(rep):
    """A report's comparable content: ``metrics()`` and its event lists."""
    return {"metrics": rep.metrics(), "scale_events": rep.scale_events,
            "preempt_events": rep.preempt_events,
            "swap_events": rep.swap_events, "per_model": rep.per_model,
            "fault_events": rep.fault_events}


def _trace(tr):
    return [dataclasses.astuple(r) for r in tr]


# ----------------------------------------------------------------------
# scenarios: each builds its runs from one package's modules
# ----------------------------------------------------------------------

def sc_mixed_plan(k):
    """test_fleet_sim: the mixed plan under a bursty trace, twice."""
    wl = _wl(k)
    plan = k.serving.plan_fleet(MIXED_POOLS, wl)
    LD = k.workload.LengthDist
    trace = k.fleet.bursty_trace(40.0, 60.0, seed=7, prompt=LD(512, cv=0.3),
                                 gen=LD(128, cv=0.3))
    specs = k.fleet.fleet_from_plan(plan, decode_lanes=4)
    runs = [k.fleet.FleetSim(specs, trace, fmt=wl.fmt, ttft_slo_s=2.0,
                             tpot_slo_s=0.05).run() for _ in range(2)]
    return {"trace": _trace(trace), "runs": [_report(r) for r in runs]}


def sc_steady_state(k):
    wl = _wl(k)
    plan = k.serving.plan_fleet(MIXED_POOLS, wl)
    trace = k.fleet.constant_trace(plan.requests_per_s * 1.2, 60.0,
                                   wl.prompt_len, wl.gen_len)
    return _report(k.fleet.FleetSim(k.fleet.fleet_from_plan(plan), trace,
                                    fmt=wl.fmt).run())


def sc_homogeneous(k):
    wl = _wl(k)
    hplan = k.serving.homogeneous_baseline("cmp-170hx-nofma", 8, wl)
    trace = k.fleet.constant_trace(hplan.requests_per_s * 1.2, 60.0,
                                   wl.prompt_len, wl.gen_len)
    return _report(k.fleet.FleetSim(
        [k.fleet.NodeSpec("cmp-170hx-nofma", 8, "both")], trace,
        fmt=wl.fmt).run())


def sc_kv_handoff(k):
    """The single-request handoff at two prompt lengths: the record's
    phase times and the handoff seconds."""
    a100 = k.dp.get_profile("a100-40g")
    cmp = k.dp.get_profile("cmp-170hx-nofma")
    out = {"h": [k.serving.kv_handoff_seconds(a100, n, peer=cmp)
                 for n in (512, 1024)] +
           [k.serving.kv_handoff_seconds(a100, 512)]}
    for plen in (512, 1024):
        trace = [k.workload.FleetRequest(uid=0, arrival_s=0.0,
                                         prompt_len=plen, gen_len=32)]
        sim = k.fleet.FleetSim([k.fleet.NodeSpec("a100-40g", 1, "prefill"),
                                k.fleet.NodeSpec("cmp-170hx-nofma", 1,
                                                 "decode")],
                               trace, fmt="q8_0")
        rep = sim.run()
        rec = sim.records[0]
        out[plen] = (_report(rep), rec.done, rec.t_prefill_done,
                     rec.t_decode_enter)
    return out


def sc_disaggregated_vs_homogeneous(k):
    wl = _wl(k)
    plan = k.serving.plan_fleet(MIXED_POOLS, wl)
    trace = k.fleet.bursty_trace(60.0, 60.0, seed=0)
    slo = dict(ttft_slo_s=2.0, tpot_slo_s=0.05)
    NS = k.fleet.NodeSpec
    return [_report(k.fleet.FleetSim(specs, trace, fmt=wl.fmt, **slo).run())
            for specs in (k.fleet.fleet_from_plan(plan, decode_lanes=4),
                          [NS("a100-40g", 2, "both", 4)],
                          [NS("cmp-170hx-nofma", 8, "both", 4)])]


def sc_routers(k):
    """The four routers (and the default) over one Poisson trace."""
    wl = _wl(k)
    plan = k.serving.plan_fleet(MIXED_POOLS, wl)
    trace = k.fleet.poisson_trace(20.0, 30.0, seed=1)
    specs = k.fleet.fleet_from_plan(plan, decode_lanes=4)
    F = k.fleet
    routers = (None, F.LeastLoadedRouter(), F.CostAwareRouter(),
               F.SLOAwareRouter(ttft_slo_s=2.0, tpot_slo_s=0.05),
               F.PreemptionAwareSLORouter(tpot_slo_s=0.05))
    return [_report(F.FleetSim(specs, trace, fmt=wl.fmt, router=r).run())
            for r in routers]


def sc_autoscaler(k):
    F = k.fleet
    trace = F.diurnal_trace(base_rps=5.0, peak_rps=60.0, duration_s=120.0,
                            seed=3, period_s=120.0)
    base = [F.NodeSpec("a100-40g", 2, "prefill", 1),
            F.NodeSpec("cmp-170hx-nofma", 2, "decode", 4)]
    asc = F.QueueDepthAutoscaler(
        template=F.NodeSpec("cmp-170hx-nofma", 1, "decode", 4),
        interval_s=10.0, min_nodes=2, max_nodes=16, cold_start_s=15.0)
    scaled = F.FleetSim(base, trace, fmt="q8_0", autoscaler=asc).run()
    fixed = F.FleetSim(base, trace, fmt="q8_0").run()
    return [_report(scaled), _report(fixed)]


def _saturated_fleet(k):
    NS = k.fleet.NodeSpec
    return [NS("a100-40g", 1, "prefill"),
            NS("cmp-170hx-nofma", 1, "decode", decode_lanes=8,
               kv_pool_pages=40, page_size=16),
            NS("cmp-170hx-nofma", 1, "decode", decode_lanes=8,
               kv_pool_pages=512, page_size=16)]


def _tail_trace(k):
    LD = k.workload.LengthDist
    return k.fleet.poisson_trace(3.0, 40.0, seed=2, prompt=LD(256, cv=0.3),
                                 gen=LD(128, cv=0.5))


def sc_migration(k):
    """test_preemption: page-exhaustion migration (and the baseline
    without it, and the rerun), with per-record and per-node state."""
    F = k.fleet
    trace = _tail_trace(k)
    base = F.FleetSim(_saturated_fleet(k), trace, fmt="q8_0").run()
    sim = F.FleetSim(_saturated_fleet(k), trace, fmt="q8_0",
                     preemption=F.PreemptionPolicy())
    mig = sim.run()
    again = F.FleetSim(_saturated_fleet(k), trace, fmt="q8_0",
                       preemption=F.PreemptionPolicy()).run()
    return {"base": _report(base), "mig": _report(mig),
            "again": _report(again),
            "records": [(r.req.uid, r.done, r.preemptions)
                        for r in sim.records],
            "inbound": [(n.inbound_pages, n.inbound_inflight)
                        for n in sim.nodes + sim.retired]}


def sc_straggler(k):
    F = k.fleet
    pol = F.PreemptionPolicy(on_page_exhaustion=True, straggler_factor=1.5,
                             max_migrations_per_request=1)
    return _report(F.FleetSim(_saturated_fleet(k), _tail_trace(k),
                              fmt="q8_0", preemption=pol).run())


def sc_simnode_pages(k):
    cmp_prof = k.dp.get_profile("cmp-170hx-nofma")
    node = k.fleet.SimNode("n0", cmp_prof, "decode", "q8_0", page_size=16)
    return ([node.migration_pages(n) for n in (1, 16, 17, 260)],
            node.kv_page_transfer_s(17, peer=k.dp.get_profile("a100-40g")),
            node.kv_page_transfer_s(17))


def _mm_fleet(k, hbm_gb):
    NS = k.fleet.NodeSpec
    return [NS("a100-40g", 1, "prefill", model_ids=("big", "small"),
               hbm_gb=40.0),
            NS("cmp-170hx-nofma", 1, "decode", decode_lanes=8,
               model_ids=("big", "small"), resident=("big",),
               hbm_gb=hbm_gb, page_size=16),
            NS("cmp-170hx-nofma", 1, "decode", decode_lanes=8,
               model_ids=("big", "small"), resident=("small",),
               hbm_gb=hbm_gb, page_size=16)]


def _mm_specs(k):
    return {"big": k.pm.QWEN25_1P5B, "small": k.pm.QWEN25_0P5B}


def _mm_trace(k):
    LD = k.workload.LengthDist
    return k.fleet.multimodel_trace(
        k.fleet.poisson_trace(2.0, 60.0, seed=3, prompt=LD(256, cv=0.3),
                              gen=LD(128, cv=0.4)),
        {"big": 1, "small": 1}, seed=1)


def sc_affinity(k):
    """test_modelpool: affinity-aware vs blind routing, and the
    multi-model mix at 2.5 GB twice."""
    F = k.fleet
    trace = _mm_trace(k)
    out = {"trace": _trace(trace)}
    for name, hbm, aware in (("aware", 2.0, True), ("blind", 2.0, False),
                             ("mm1", 2.5, True), ("mm2", 2.5, True)):
        out[name] = _report(F.FleetSim(
            _mm_fleet(k, hbm), trace, fmt="q8_0", model_specs=_mm_specs(k),
            router=F.LeastLoadedRouter(model_aware=aware)).run())
    return out


def sc_simnode_swaps(k):
    node = k.fleet.SimNode("n0", k.dp.get_profile("cmp-170hx-nofma"),
                           "decode", "q8_0", decode_lanes=4, page_size=16,
                           models=_mm_specs(k), resident_models=("big",),
                           hbm_gb=2.0)
    out = [node.kv_pool_pages, node.swap_in("small", now=1.0),
           tuple(node.resident_models), node.model_evictions,
           node.swap_in("small", now=2.0)]
    slot = node.make_slot(0, 256, 64, model_id="small")
    node.decode_admit(slot, 2.0)
    out += [node.swap_in("big", now=3.0), tuple(node.resident_models),
            node.kv_pages_free(), node.model_swaps]
    return out


def sc_preemption_aware_router(k):
    F = k.fleet
    trace = _tail_trace(k)
    return [_report(F.FleetSim(_saturated_fleet(k), trace, fmt="q8_0",
                               router=router,
                               preemption=F.PreemptionPolicy()).run())
            for router in (F.SLOAwareRouter(tpot_slo_s=0.05),
                           F.PreemptionAwareSLORouter(tpot_slo_s=0.05))]


def sc_spans_and_gauges(k):
    """test_obs: the simulator's spans on the sim clock and the
    registry's gauges."""
    LD = k.workload.LengthDist
    trace = k.fleet.poisson_trace(10.0, 2.0, seed=3, prompt=LD(256, cv=0.3),
                                  gen=LD(64, cv=0.3))
    reg = k.obs.MetricsRegistry()
    tr = k.obs.SpanTracer(registry=reg)
    rep = k.fleet.FleetSim([k.fleet.NodeSpec("cmp-170hx-nofma", 2, "both",
                                             4)], trace, fmt="q8_0",
                           tracer=tr, registry=reg).run()
    spans = [(s.name, s.t0, s.t1) for s in tr.spans]
    gauges = {n: getattr(reg[n], "samples", None) or reg[n].value
              for n in reg.names()}
    return {"report": _report(rep), "spans": spans, "gauges": gauges,
            "nested": tr.check_well_nested(),
            "n_prefill": len(tr.spans_named("sim.prefill")),
            "n_decode": len(tr.spans_named("sim.decode"))}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_mixed_plan, sc_steady_state, sc_homogeneous, sc_kv_handoff,
    sc_disaggregated_vs_homogeneous, sc_routers, sc_autoscaler,
    sc_migration, sc_straggler, sc_simnode_pages, sc_affinity,
    sc_simnode_swaps, sc_preemption_aware_router, sc_spans_and_gauges)}


@pytest.fixture(scope="module")
def results():
    """Every scenario run once from each package."""
    return {name: {p: f(k) for p, k in PKGS.items()}
            for name, f in SCENARIOS.items()}


def _same(a, b):
    """Equal, NaN equal to NaN (a metric of an empty set is NaN in both)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[x], b[x]) for x in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(results, name):
    got = results[name]
    assert _same(got["port"], got["reference"]), name


def test_scenarios_show_what_the_reference_tests_pin(results):
    """The port's runs show the behaviour the reference's tests assert:
    determinism, completion, planner agreement, goodput ordering, the
    autoscaler's tail, migration and swaps."""
    r = {name: v["port"] for name, v in results.items()}
    a, b = r["mixed_plan"]["runs"]
    assert a["metrics"] == b["metrics"]
    assert a["metrics"]["completed"] == a["metrics"]["offered"]
    mixed, homo_a, homo_c = r["disaggregated_vs_homogeneous"]
    assert mixed["metrics"]["goodput_rps"] > max(
        homo_a["metrics"]["goodput_rps"], homo_c["metrics"]["goodput_rps"])
    scaled, fixed = r["autoscaler"]
    assert any("+1" in ev for ev in scaled["scale_events"])
    assert scaled["metrics"]["ttft_p99_s"] < fixed["metrics"]["ttft_p99_s"]
    mig = r["migration"]
    assert mig["base"]["metrics"]["preemptions"] == 0
    assert mig["mig"]["metrics"]["preemptions"] > 0
    assert mig["mig"]["metrics"]["tpot_p99_s"] < \
        mig["base"]["metrics"]["tpot_p99_s"]
    assert all(x == (0, 0) for x in mig["inbound"])
    aff = r["affinity"]
    assert aff["aware"]["metrics"]["model_swaps"] == 0
    assert aff["blind"]["metrics"]["model_swaps"] > 0
    reactive, anticip = r["preemption_aware_router"]
    assert reactive["metrics"]["preemptions"] > 0
    assert anticip["metrics"]["preemptions"] == 0
    sg = r["spans_and_gauges"]
    assert sg["nested"] and sg["n_prefill"] == \
        sg["report"]["metrics"]["completed"] > 0
    assert r["simnode_pages"][0] == [1, 1, 2, 17]


@pytest.mark.parametrize("fn,args", [
    ("plan_fleet", (MIXED_POOLS,)),
    ("plan_fleet", ({"cmp-170hx-nofma": 8},)),
    ("homogeneous_baseline", ("cmp-170hx-nofma", 8)),
    ("homogeneous_baseline", ("a100-40g", 2)),
])
def test_planner_equals_reference(fn, args):
    """The steady-state planner, field by field."""
    got = getattr(serving, fn)(*args, _wl(PKGS["port"]))
    want = getattr(jax_serving, fn)(*args, _wl(PKGS["reference"]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_validate_token_accounting_equals_reference():
    """The reference's SMOKE case (``tests/test_fleet_sim.py``): five
    requests through the prefill/decode fleet, replayed on the engine;
    the port's (on the CPU, the reference's weights carried over)
    returns the reference's dict."""
    jcfg = jax_get_config("qwen2.5-1.5b", smoke=True)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    params = params_from_jax(jax.device_get(jparams), cfg,
                             torch.device("cpu"))
    got = {}
    for p, k, ps, kw in (("reference", PKGS["reference"], jparams, {}),
                         ("port", PKGS["port"], params,
                          {"device": torch.device("cpu")})):
        trace = [k.workload.FleetRequest(uid=i, arrival_s=0.1 * (i + 1),
                                         prompt_len=8 + i,
                                         gen_len=4 + (i % 3))
                 for i in range(5)]
        sim = k.fleet.FleetSim([k.fleet.NodeSpec("a100-40g", 1, "prefill"),
                                k.fleet.NodeSpec("cmp-170hx-nofma", 1,
                                                 "decode", 2)],
                               trace, fmt="q8_0")
        report = sim.run()
        assert report.completed == len(trace)
        got[p] = k.fleet.validate_token_accounting(sim, report, jcfg if
                                                   p == "reference" else cfg,
                                                   ps, n_lanes=2, max_len=32,
                                                   **kw)
        assert got[p]["match"], got[p]["mismatches"]
        assert k.fleet.execution.simulated_token_accounting(
            sim, report) == {r.req.uid: r.req.gen_len for r in sim.records}
    assert got["port"] == got["reference"]
