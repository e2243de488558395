"""Fleet layer of the port: seeded traces, fault plans, and replays of
a trace on the real engines.

The reference's ``fleet`` package simulates a heterogeneous fleet over
time (``sim``, ``node``, ``router``, ``autoscale``); the port does not
have that simulator yet.  What it has is what checks the real engine:
``workload`` (seeded trace generators and multi-model mixes, the
reference's traces for the same seed), ``faults`` (deterministic fault
plans, the injector's counters, the recovery policy) and ``execution``
(replays on :class:`~repro_torch.serving.ServeEngine` and
:class:`~repro_torch.serving.MultiModelServeEngine` that check token
accounting, preemption exactness, crash recovery and multi-model
exactness; :mod:`repro_torch.obs.calibration` fits the scheduling model
against them).
"""

from repro_torch.fleet.execution import (ExecutionResult, FaultReplayResult,
                                         MultiModelExecutionResult,
                                         dense_hbm_bytes,
                                         run_multimodel_trace_on_engine,
                                         run_trace_on_engine,
                                         run_trace_with_faults,
                                         trace_requests,
                                         validate_multimodel_exactness,
                                         validate_preemption_exactness,
                                         validate_recovery_exactness)
from repro_torch.fleet.faults import (FAULT_KINDS, FaultEvent, FaultInjector,
                                      FaultPlan, RecoveryPolicy, RetryPolicy)
from repro_torch.fleet.workload import (FleetRequest, LengthDist,
                                        bursty_trace, constant_trace,
                                        diurnal_trace, multimodel_trace,
                                        poisson_trace, shared_prefix_trace)

__all__ = [
    "ExecutionResult", "FaultReplayResult", "MultiModelExecutionResult",
    "dense_hbm_bytes", "run_multimodel_trace_on_engine",
    "run_trace_on_engine", "run_trace_with_faults", "trace_requests",
    "validate_multimodel_exactness", "validate_preemption_exactness",
    "validate_recovery_exactness",
    "FAULT_KINDS", "FaultEvent", "FaultInjector", "FaultPlan",
    "RecoveryPolicy", "RetryPolicy",
    "FleetRequest", "LengthDist", "bursty_trace", "constant_trace",
    "diurnal_trace", "multimodel_trace", "poisson_trace",
    "shared_prefix_trace",
]
