"""Trace-driven heterogeneous fleet simulation (paper §6.2, dynamic),
the reference's ``fleet`` package for the port.

Where :mod:`repro_torch.serving.disaggregation` plans a mixed fleet's
*steady state*, this package simulates it *over time*: seeded arrival
traces, per-node queueing and continuous batching, prefill->decode KV
handoffs over each board's host link, routing policies, autoscaling,
and per-request latency/energy/cost accounting.  The simulator
(``node``, ``router``, ``sim``, ``autoscale``) is framework-free Python,
a copy of the reference's with the port's imports, and gives its
reports bit for bit for the same trace.

Quick start::

    from repro_torch.fleet import (FleetSim, LeastLoadedRouter, NodeSpec,
                                   bursty_trace, fleet_from_plan)
    from repro_torch.serving import Workload, plan_fleet

    wl = Workload(prompt_len=512, gen_len=128, fmt="q8_0")
    plan = plan_fleet({"a100-40g": 2, "cmp-170hx-nofma": 8}, wl)
    trace = bursty_trace(rate_on_rps=40.0, duration_s=120.0, seed=0)
    report = FleetSim(fleet_from_plan(plan), trace, fmt=wl.fmt).run()
    print(report.ttft_p99_s, report.goodput_rps, report.usd_per_mtok)

Modules: ``workload`` (trace generators + multi-model mixes, the
reference's traces for the same seed), ``node`` (simulated boards incl.
resident-model sets), ``router`` (placement policies incl. model
affinity and anticipated eviction cost), ``sim`` (event loop +
metrics), ``autoscale`` (queue-depth pool scaling), ``faults``
(deterministic fault plans, injection, recovery policy), ``execution``
(replays on the real :class:`~repro_torch.serving.ServeEngine` and
:class:`~repro_torch.serving.MultiModelServeEngine`, on the card unless
``device="cpu"``, that check token accounting, preemption exactness,
crash recovery and multi-model exactness;
:mod:`repro_torch.obs.calibration` fits the scheduling model against
them).
"""

from repro_torch.fleet.autoscale import QueueDepthAutoscaler
from repro_torch.fleet.execution import (ExecutionResult, FaultReplayResult,
                                         MultiModelExecutionResult,
                                         dense_hbm_bytes,
                                         diff_token_accounting,
                                         run_multimodel_trace_on_engine,
                                         run_trace_on_engine,
                                         run_trace_with_faults,
                                         simulated_token_accounting,
                                         trace_requests,
                                         validate_multimodel_exactness,
                                         validate_preemption_exactness,
                                         validate_recovery_exactness,
                                         validate_token_accounting)
from repro_torch.fleet.faults import (FAULT_KINDS, FaultEvent, FaultInjector,
                                      FaultPlan, RecoveryPolicy, RetryPolicy)
from repro_torch.fleet.node import SimNode
from repro_torch.fleet.router import (CostAwareRouter, LeastLoadedRouter,
                                      PreemptionAwareSLORouter, Router,
                                      SLOAwareRouter, anticipated_eviction_s,
                                      model_affinity_penalty)
from repro_torch.fleet.sim import (FleetReport, FleetSim, NodeSpec,
                                   PreemptionPolicy, RequestRecord,
                                   fleet_from_plan)
from repro_torch.fleet.workload import (FleetRequest, LengthDist,
                                        bursty_trace, constant_trace,
                                        diurnal_trace, multimodel_trace,
                                        poisson_trace, shared_prefix_trace)

__all__ = [
    "QueueDepthAutoscaler", "ExecutionResult", "FaultReplayResult",
    "MultiModelExecutionResult", "dense_hbm_bytes",
    "diff_token_accounting",
    "run_multimodel_trace_on_engine", "run_trace_on_engine",
    "run_trace_with_faults", "simulated_token_accounting",
    "trace_requests", "validate_multimodel_exactness",
    "validate_preemption_exactness", "validate_recovery_exactness",
    "validate_token_accounting",
    "FAULT_KINDS", "FaultEvent", "FaultInjector", "FaultPlan",
    "RecoveryPolicy", "RetryPolicy",
    "SimNode", "CostAwareRouter",
    "LeastLoadedRouter", "PreemptionAwareSLORouter", "Router",
    "SLOAwareRouter", "anticipated_eviction_s", "model_affinity_penalty",
    "FleetReport",
    "FleetSim", "NodeSpec", "PreemptionPolicy", "RequestRecord",
    "fleet_from_plan",
    "FleetRequest", "LengthDist", "bursty_trace", "constant_trace",
    "diurnal_trace", "multimodel_trace", "poisson_trace",
    "shared_prefix_trace",
]
