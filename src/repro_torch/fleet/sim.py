"""Deterministic discrete-event simulator of a heterogeneous fleet.

The event loop advances a set of :class:`~repro_torch.fleet.node.SimNode`\\ s
through a seeded arrival trace under a routing policy:

``arrive`` -> route to a prefill-capable node (FIFO) -> ``prefill_done``
-> route to a decode-capable node, shipping the KV over the bottleneck
interconnect -> ``decode_enter`` -> lane-limited continuous batching ->
completion.  The KV handoff is charged twice, deliberately asymmetric:
the *source* board's occupancy pays its own-link egress time (exactly
the static planner's ``effective_prefill_tps`` derating, which keeps
the two models in steady-state agreement), while the *request's* TTFT
pays the bottleneck-endpoint transfer time.

Determinism: all randomness lives in the trace generator's seed; events
are totally ordered by (time, insertion sequence) and all metric math
is straight float arithmetic -- the same seed yields bit-identical
reports.

Outputs (:class:`FleetReport`): TTFT/TPOT p50/p99, completed and
goodput requests/s, generated tokens/s, average watts (idle floor +
integrated dynamic power), $/hour (amortized capex + energy) and
$/Mtok.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.device_profile import get_profile
from repro_torch.core.perf_model import LLMSpec, QWEN25_1P5B
from repro_torch.fleet.faults import FaultEvent, FaultInjector, FaultPlan, \
    RecoveryPolicy
from repro_torch.fleet.node import SimNode
from repro_torch.fleet.router import LeastLoadedRouter, Router
from repro_torch.fleet.workload import FleetRequest
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SpanTracer
from repro_torch.serving.disaggregation import FleetPlan
from repro_torch.serving.phase_model import capex_usd_per_hour, energy_usd_per_hour
from repro_torch.train.fault_tolerance import StragglerMonitor


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """A pool of identical boards with one role."""

    profile: str
    count: int
    role: str                 # "prefill" | "decode" | "both"
    decode_lanes: int = 1
    #: paged-KV model (see SimNode): pages per board; None = unconstrained
    kv_pool_pages: Optional[int] = None
    page_size: int = 16
    #: multi-model serving: catalog of model ids this board can host
    #: (resolved against FleetSim's ``model_specs``), the subset resident
    #: at t=0 (None = all), and the HBM budget weights and KV pages share
    model_ids: Optional[Tuple[str, ...]] = None
    resident: Optional[Tuple[str, ...]] = None
    hbm_gb: Optional[float] = None
    #: boards run the engine's copy-on-write prefix cache: slots of one
    #: prefix family share its full prefix pages (see SimNode)
    prefix_sharing: bool = False


def fleet_from_plan(plan: FleetPlan, decode_lanes: int = 1) -> List[NodeSpec]:
    """Node specs realizing a static planner's role assignment."""
    return [NodeSpec(profile=a.profile, count=a.count, role=a.role,
                     decode_lanes=decode_lanes)
            for a in plan.assignments]


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """When the fleet evicts a live decode and replays it elsewhere.

    * ``on_page_exhaustion`` -- whenever a board's page pool goes
      over-committed (its KV would spill over the PCIe 1.1 x4 host
      link at ~1000x HBM cost), shed resident decodes -- largest
      remaining work first, the "long decode" of the power-capping
      motivation -- until the pool fits or no destination will take
      them;
    * ``straggler_factor`` -- at every decode event, migrate a slot
      whose predicted completion HERE exceeds ``factor`` x its
      predicted completion on the best peer INCLUDING the page
      transfer time (None disables);
    * ``max_migrations_per_request`` -- thrash bound: a request that
      has already moved this many times is pinned where it is.
    """

    on_page_exhaustion: bool = True
    straggler_factor: Optional[float] = None
    max_migrations_per_request: int = 1


@dataclasses.dataclass
class RequestRecord:
    """Per-request timeline collected by the simulator."""

    req: FleetRequest
    prefill_node: Optional[str] = None
    decode_node: Optional[str] = None
    t_prefill_start: Optional[float] = None
    t_prefill_done: Optional[float] = None
    t_decode_enter: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    energy_j: float = 0.0
    preemptions: int = 0      # times this request was evicted mid-decode

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def ttft_s(self) -> float:
        return self.t_first_token - self.req.arrival_s

    @property
    def tpot_s(self) -> float:
        if self.req.gen_len <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / (self.req.gen_len - 1)


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Aggregate metrics of one simulated run."""

    offered: int
    completed: int
    makespan_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    tpot_p50_s: float
    tpot_p99_s: float
    requests_per_s: float
    goodput_rps: float
    gen_tokens_per_s: float
    avg_watts: float
    energy_j: float
    joules_per_request: float   # mean solo-cost attribution (completed)
    usd_per_hour: float
    usd_per_mtok: float
    preemptions: int = 0        # mid-decode evictions across the fleet
    pages_migrated: int = 0     # KV pages shipped between boards
    model_swaps: int = 0        # weight loads over host links
    swap_bytes: float = 0.0     # weight bytes those swaps moved
    #: per-model decode quality/efficiency: (model_id, tpot_p50_s,
    #: gen_tokens, tokens_per_joule) -- the power-aware per-model
    #: accounting; empty for single-model traces
    per_model: Tuple[Tuple[str, float, int, float], ...] = ()
    scale_events: Tuple[str, ...] = ()
    preempt_events: Tuple[str, ...] = ()
    swap_events: Tuple[str, ...] = ()
    # fault-tolerance accounting (FaultPlan/RecoveryPolicy runs)
    crashes: int = 0            # boards lost mid-run
    derates: int = 0            # compute/thermal derate events
    link_faults: int = 0        # host-link degradation windows
    transients: int = 0         # transient dispatch stalls
    retries: int = 0            # request retry attempts fired
    hedges: int = 0             # tail-latency hedges launched
    requests_lost: int = 0      # retries exhausted / no destination
    recovered_lanes: int = 0    # crashed lanes resumed from checkpoint
    replayed_from_prompt: int = 0  # crashed lanes with no usable ckpt
    checkpoints: int = 0        # checkpoint ticks taken
    fault_events: Tuple[str, ...] = ()
    derate_detected: Tuple[str, ...] = ()   # straggler-monitor verdicts

    def metrics(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d.pop("scale_events")
        d.pop("preempt_events")
        d.pop("swap_events")
        d.pop("per_model")
        d.pop("fault_events")
        d.pop("derate_detected")
        return d


class FleetSim:
    """Trace-driven simulation of a routed heterogeneous fleet."""

    def __init__(self, specs: Sequence[NodeSpec],
                 trace: Sequence[FleetRequest], fmt: str = "q8_0",
                 spec: LLMSpec = QWEN25_1P5B,
                 router: Optional[Router] = None,
                 ttft_slo_s: Optional[float] = None,
                 tpot_slo_s: Optional[float] = None,
                 power_usd_per_kwh: float = 0.10,
                 amortization_years: float = 3.0,
                 autoscaler=None,
                 preemption: Optional[PreemptionPolicy] = None,
                 model_specs: Optional[Dict[str, LLMSpec]] = None,
                 tracer: Optional[SpanTracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 faults: Optional[FaultPlan] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 detect_stragglers: bool = False,
                 slo=None, flight=None):
        self.fmt = fmt
        self.spec = spec
        # deterministic SIM-CLOCK telemetry: spans carry simulated
        # seconds (add_span, never the host clock), so the same seed
        # yields a bit-identical trace file
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else SpanTracer(
            enabled=False, registry=self.registry)
        # SLO burn-rate control loop (an SLOController) fed with SIM
        # seconds at every request completion, and a flight recorder
        # tapped into the tracer (dumped on simulated crashes)
        self.slo = slo
        self.flight = flight
        if flight is not None:
            flight.attach(tracer=self.tracer)
        self.model_specs = model_specs
        self.router = router or LeastLoadedRouter()
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        self.power_usd_per_kwh = power_usd_per_kwh
        self.amortization_years = amortization_years
        self.autoscaler = autoscaler
        self.nodes: List[SimNode] = []
        self.retired: List[SimNode] = []
        self._node_seq = 0
        self._added_at: Dict[str, float] = {}
        self._retired_at: Dict[str, float] = {}
        for ns in specs:
            for _ in range(ns.count):
                self.add_node(ns, now=0.0)
        self.records = [RequestRecord(req=r) for r in trace]
        self._slot_rec: Dict[Tuple[str, int], RequestRecord] = {}
        self.scale_events: List[str] = []
        self.swap_events: List[str] = []
        self.preemption = preemption
        self.preempt_events: List[str] = []
        self._migrations: Dict[int, int] = {}   # uid -> moves so far
        self._heap: List[tuple] = []
        self._seq = 0
        # -- fault tolerance (repro_torch.fleet.faults) ----------------------
        self.faults = faults
        self.recovery = recovery
        self.injector = (FaultInjector(faults, self.registry)
                         if faults is not None else None)
        self.fault_events: List[str] = []
        self.crashes = 0
        self.derates = 0
        self.link_faults = 0
        self.transients = 0
        self.retries = 0
        self.hedges = 0
        self.requests_lost = 0
        self.recovered_lanes = 0
        self.replayed_from_prompt = 0
        self.checkpoints = 0
        self._attempts: Dict[int, int] = {}      # uid -> retries so far
        self._lost_uids: set = set()
        self._hedged: set = set()                # uids hedged once
        self._hedge_nodes: Dict[int, str] = {}   # uid -> hedge node_id
        # derate detection: the training-loop straggler monitor reused
        # on the SIM clock (injectable, so detection is deterministic)
        self._now = 0.0
        self.straggler_monitor: Optional[StragglerMonitor] = None
        if faults is not None or detect_stragglers:
            self.straggler_monitor = StragglerMonitor(
                n_hosts=0, warmup=4, clock=lambda: self._now)
        self._host_idx: Dict[str, int] = {}      # node_id -> monitor host
        self._host_ids: List[str] = []           # monitor host -> node_id
        self._obs_last: Dict[str, Tuple[float, float]] = {}
        self._flagged: set = set()
        self.derate_detected: List[str] = []

    # -- fleet mutation (autoscaler hooks) -----------------------------
    def add_node(self, ns: NodeSpec, now: float) -> SimNode:
        models = None
        if ns.model_ids is not None:
            assert self.model_specs is not None, (
                "NodeSpec names model_ids but FleetSim has no model_specs")
            models = {m: self.model_specs[m] for m in ns.model_ids}
        node = SimNode(node_id=f"{ns.profile}/{ns.role}#{self._node_seq}",
                       profile=get_profile(ns.profile), role=ns.role,
                       fmt=self.fmt, spec=self.spec,
                       decode_lanes=ns.decode_lanes,
                       page_size=ns.page_size,
                       kv_pool_pages=ns.kv_pool_pages,
                       models=models, resident_models=ns.resident,
                       hbm_gb=ns.hbm_gb,
                       prefix_sharing=ns.prefix_sharing)
        self._node_seq += 1
        node.available_at = now
        self.nodes.append(node)
        self._added_at[node.node_id] = now
        node.bind_registry(self.registry)
        return node

    def retire_node(self, node: SimNode, now: float) -> None:
        """Stop routing to ``node``; it leaves once its work drains."""
        node.draining = True
        self._maybe_reap(node, now)

    def _maybe_reap(self, node: SimNode, now: float) -> None:
        busy = (node.prefill_busy or node.prefill_queue
                or node.decode_active or node.decode_queue
                or node.inbound_inflight)
        if node.draining and not busy and node in self.nodes:
            self.nodes.remove(node)
            self.retired.append(node)
            self._retired_at[node.node_id] = now

    def _routable(self, now: float) -> List[SimNode]:
        return [n for n in self.nodes
                if not n.draining and not n.failed
                and n.available_at <= now]

    @property
    def _retry_policy(self):
        return self.recovery.retry if self.recovery is not None else None

    def _work_remains(self) -> bool:
        """Undone requests that are still recoverable (lost requests
        never finish -- they must not keep periodic ticks alive)."""
        return any(not rec.done and rec.req.uid not in self._lost_uids
                   for rec in self.records)

    # -- event plumbing -------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload))

    def _schedule_decode(self, node: SimNode, now: float) -> None:
        t = node.decode_next_event_s(now)
        if t is not None:
            self._push(t, "decode", (node, node.decode_version))

    # -- event handlers -------------------------------------------------
    def _on_arrive(self, rec: RequestRecord, now: float) -> None:
        if rec.t_prefill_start is not None or rec.done:
            return    # a hedge copy (or earlier attempt) already took it
        try:
            node = self.router.route_prefill(rec, self._routable(now), now)
        except AssertionError:
            # no prefill-capable node survives right now (crashes):
            # back off and retry instead of dying
            self._retry(rec, now, "no_prefill_node")
            return
        rec.prefill_node = node.node_id
        pol = self._retry_policy
        if (pol is not None and pol.hedge_after_s is not None
                and rec.req.uid not in self._hedged):
            self._hedged.add(rec.req.uid)
            self._push(now + pol.hedge_after_s, "hedge", rec)
        if not node.prefill_busy and not node.prefill_queue:
            self._start_prefill(node, rec, now)
        else:
            node.prefill_queue.append(rec)

    def _start_prefill(self, node: SimNode, rec: RequestRecord,
                       now: float) -> None:
        rec.prefill_node = node.node_id   # a hedge may win on a peer
        rec.t_prefill_start = now
        done_t = node.start_prefill(rec, now)
        self.tracer.add_span("sim.prefill", now, done_t,
                             track=node.node_id, uid=rec.req.uid,
                             prompt_len=rec.req.prompt_len)
        self._push(done_t, "prefill_done", (node, rec))

    def _prefill_claimable(self, node: SimNode, rec: RequestRecord) -> bool:
        """May ``node`` start this queued record?  Stale entries -- an
        attempt that was retried elsewhere, a hedge whose twin already
        started, a finished request -- are skipped at pop time."""
        if rec.t_prefill_start is not None or rec.done:
            return False
        return (rec.prefill_node == node.node_id
                or self._hedge_nodes.get(rec.req.uid) == node.node_id)

    def _on_hedge(self, rec: RequestRecord, now: float) -> None:
        """Tail-latency hedge: the request is still QUEUED after
        ``hedge_after_s`` -- launch a duplicate on another board.  First
        to start prefill wins; the loser is skipped at pop time."""
        if rec.t_prefill_start is not None or rec.done \
                or rec.req.uid in self._lost_uids:
            return
        cands = [n for n in self._routable(now)
                 if n.node_id != rec.prefill_node]
        try:
            node = self.router.route_prefill(rec, cands, now)
        except AssertionError:
            return            # no second prefill-capable board exists
        self._hedge_nodes[rec.req.uid] = node.node_id
        self.hedges += 1
        if self.injector is not None:
            self.injector.count_hedge()
        self.fault_events.append(
            f"t={now:.2f}s uid={rec.req.uid} HEDGE -> {node.node_id}")
        if not node.prefill_busy and not node.prefill_queue:
            self._start_prefill(node, rec, now)
        else:
            node.prefill_queue.append(rec)

    def _retry(self, rec: RequestRecord, now: float, reason: str) -> None:
        """Request-layer retry: wipe the attempt's timeline and re-enter
        through arrival after a capped exponential backoff.  Arrival
        time is NOT reset, so TTFT/deadline pay for the fault.  With no
        RecoveryPolicy (or an exhausted one) the request is LOST."""
        uid = rec.req.uid
        if uid in self._lost_uids or rec.done:
            return
        pol = self._retry_policy
        attempt = self._attempts.get(uid, 0) + 1
        if pol is None or not pol.allows(attempt,
                                         now - rec.req.arrival_s):
            self._lost_uids.add(uid)
            self.requests_lost += 1
            if self.injector is not None:
                self.injector.count_lost()
            self.fault_events.append(
                f"t={now:.2f}s uid={uid} LOST ({reason}, "
                f"attempt={attempt})")
            self.tracer.add_instant("sim.request_lost", now,
                                    track="fleet", uid=uid, reason=reason)
            return
        self._attempts[uid] = attempt
        self.retries += 1
        if self.injector is not None:
            self.injector.count_retry()
        rec.prefill_node = None
        rec.decode_node = None
        rec.t_prefill_start = None
        rec.t_prefill_done = None
        rec.t_decode_enter = None
        rec.t_first_token = None
        self._hedge_nodes.pop(uid, None)
        delay = pol.backoff_s(attempt)
        self.fault_events.append(
            f"t={now:.2f}s uid={uid} RETRY#{attempt} ({reason}) "
            f"backoff={delay * 1e3:.0f}ms")
        self._push(now + delay, "arrive", rec)

    def _on_prefill_done(self, node: SimNode, rec: RequestRecord,
                         now: float) -> None:
        if node.failed:
            return   # board died mid-prefill; the crash already retried
        rec.t_prefill_done = now
        node.prefill_active = None
        mid = getattr(rec.req, "model_id", None)
        try:
            dst = self.router.route_decode(rec, node, self._routable(now),
                                           now)
        except AssertionError:
            # every decode-capable board is dead: the prefill output has
            # nowhere to go -- back off and retry (or report LOST)
            self._retry(rec, now, "no_decode_node")
            self._on_prefill_free(node, now)
            return
        rec.decode_node = dst.node_id
        plen = rec.req.prompt_len
        if dst is node:
            occupancy_s = transfer_s = 0.0    # KV stays in HBM
        else:
            occupancy_s = node.prefill_handoff_s(plen, mid=mid)
            transfer_s = node.prefill_handoff_s(plen, peer=dst.profile,
                                                mid=mid)
        rec.energy_j += node.request_energy_j(plen, rec.req.gen_len,
                                              phase="prefill", mid=mid)
        dst.inbound_inflight += 1      # blocks reaping until KV lands
        self._push(now + transfer_s, "decode_enter", (dst, rec))
        if occupancy_s > 0:
            self._push(now + occupancy_s, "prefill_free", node)
        else:
            self._on_prefill_free(node, now)

    def _on_prefill_free(self, node: SimNode, now: float) -> None:
        if node.failed:
            return
        node.prefill_busy = False
        while node.prefill_queue:
            rec = node.prefill_queue.popleft()
            if not self._prefill_claimable(node, rec):
                continue          # stale retry copy / lost hedge twin
            self._start_prefill(node, rec, now)
            break
        self._maybe_reap(node, now)

    def _on_decode_enter(self, node: SimNode, rec: RequestRecord,
                         now: float, pinned: bool = False) -> None:
        node.inbound_inflight -= 1
        mid = getattr(rec.req, "model_id", None)
        if node.failed:
            # the KV (or the swap) was in flight TO a board that died:
            # the prefill output is gone, recompute from the prompt
            self._retry(rec, now, "crash_inflight")
            return
        if pinned:
            node.unpin_model(mid)
        if node.models is not None and mid is not None:
            # weights must be resident before the first decode step: a
            # cold model swaps in over the host link, and the request
            # re-enters once the shards land.  The pin keeps the model
            # from being LRU-evicted while its weights are in flight
            # (a second request for the same model piggybacks on the
            # swap already underway: swap_in sees it resident).
            swap_s = node.swap_in(mid, now)
            if swap_s > 0:
                node.pin_model(mid)
                node.inbound_inflight += 1   # still en route: no reaping
                self.swap_events.append(
                    f"t={now:.2f}s {node.node_id} <- weights[{mid}] "
                    f"({swap_s * 1e3:.0f}ms)")
                self.tracer.add_span("sim.swap", now, now + swap_s,
                                     track=f"{node.node_id}/link",
                                     model_id=mid, uid=rec.req.uid)
                self._push(now + swap_s, "decode_enter", (node, rec, True))
                return
        rec.t_decode_enter = now
        if rec.req.gen_len <= 0:      # nothing to decode: done on arrival
            rec.t_first_token = now
            rec.t_done = now
            self._maybe_reap(node, now)
            return
        rec.energy_j += node.request_energy_j(rec.req.prompt_len,
                                              rec.req.gen_len,
                                              phase="decode", mid=mid)
        self._finish(node, node.decode_advance(now), now)
        slot = node.make_slot(rec.req.uid, rec.req.prompt_len,
                              rec.req.gen_len, model_id=mid,
                              prefix_id=getattr(rec.req, "prefix_id",
                                                None),
                              prefix_len=getattr(rec.req, "prefix_len",
                                                 0))
        self._slot_rec[(node.node_id, rec.req.uid)] = rec
        node.decode_admit(slot, now)
        self._maybe_preempt(node, now)
        self._schedule_decode(node, now)

    def _on_decode(self, node: SimNode, version: int, now: float) -> None:
        if version != node.decode_version or node not in self.nodes:
            return                          # stale membership snapshot
        self._finish(node, node.decode_advance(now), now)
        if self.straggler_monitor is not None:
            self._observe_decode(node)
        self._maybe_preempt(node, now)
        self._schedule_decode(node, now)
        self._maybe_reap(node, now)

    def _observe_decode(self, node: SimNode) -> None:
        """Feed the straggler monitor one per-token decode-time sample
        for ``node``, on the SIM clock (the monitor's injected clock
        reads ``self._now``) -- a derated board's seconds-per-token EWMA
        drifts above the fleet median and gets flagged, deterministically."""
        mon = self.straggler_monitor
        t = mon.clock()
        host = self._host_idx.get(node.node_id)
        if host is None:
            host = mon.add_host()
            self._host_idx[node.node_id] = host
            self._host_ids.append(node.node_id)
        if not node.decode_active:
            # going idle: drop the baseline, or the next busy window's
            # sample would charge the idle gap as decode time
            self._obs_last.pop(node.node_id, None)
            return
        last = self._obs_last.get(node.node_id)
        self._obs_last[node.node_id] = (t, node.tokens_decoded)
        if last is None:
            return
        t0, tok0 = last
        dtok = node.tokens_decoded - tok0
        if t <= t0 or dtok <= 0:
            return
        mon.record(host, (t - t0) / dtok)
        for idx in mon.stragglers():
            nid = self._host_ids[idx]
            if nid not in self._flagged:
                self._flagged.add(nid)
                self.derate_detected.append(
                    f"t={t:.2f}s STRAGGLER {nid} "
                    f"ewma={mon.ewma[idx]:.4g}s/tok")
                self.tracer.add_instant("sim.straggler_detected", t,
                                        track=nid)

    # -- preemption & KV-page migration --------------------------------
    def _movable(self, node: SimNode) -> List:
        """Resident slots eligible for eviction, most remaining work
        first (deterministic: ties break on uid)."""
        cap = (self.preemption.max_migrations_per_request
               if self.preemption else 0)
        eligible = sorted(node.decode_active.values(),
                          key=lambda s: (-(s.gen_len - s.tokens_done),
                                         s.uid))
        return [s for s in eligible
                if self._migrations.get(s.uid, 0) < cap]

    def _maybe_preempt(self, node: SimNode, now: float) -> None:
        """Apply the preemption policy to ``node`` after its decode
        state changed: shed slots while the page pool is over-committed,
        and (optionally) rescue stragglers a peer would finish sooner
        despite paying the page transfer."""
        pol = self.preemption
        if pol is None or node not in self.nodes:
            return
        if pol.on_page_exhaustion:
            while node.kv_pages_free() < 0:
                moved = False
                for slot in self._movable(node):
                    dst = self.router.route_migration(
                        slot, node, self._routable(now), now)
                    if dst is not None:
                        self._migrate(node, slot, dst, now)
                        moved = True
                        break
                if not moved:       # nowhere to shed to: spill and bear it
                    break
        if pol.straggler_factor is not None:
            for slot in self._movable(node):
                remaining = slot.gen_len - slot.tokens_done
                if remaining <= 0:
                    continue
                t_here = remaining * node.est_decode_step_s(
                    slot.prompt_len + int(slot.tokens_done), extra=0,
                    mid=getattr(slot, "model_id", None))
                dst = self.router.route_migration(
                    slot, node, self._routable(now), now)
                if dst is None:
                    continue
                ctx = slot.prompt_len + int(slot.tokens_done)
                t_there = (node.kv_page_transfer_s(
                    node.migration_pages(ctx), peer=dst.profile)
                    + remaining * dst.est_decode_step_s(
                        ctx, extra=1, mid=getattr(slot, "model_id", None)))
                if t_here > pol.straggler_factor * t_there:
                    self._migrate(node, slot, dst, now)

    def _migrate(self, src: SimNode, slot, dst: SimNode,
                 now: float) -> None:
        """Evict ``slot`` from ``src`` and replay it on ``dst`` after
        its KV pages cross the host link (the request is in flight --
        nobody decodes it -- for the whole transfer)."""
        src.preempt_slot(slot.uid, now)
        ctx = slot.prompt_len + int(slot.tokens_done)
        n_pg = src.migration_pages(ctx)
        transfer_s = src.kv_page_transfer_s(n_pg, peer=dst.profile)
        mid = getattr(slot, "model_id", None)
        if dst.models is not None and mid is not None:
            # a destination without the slot's model hot swaps its
            # weights in alongside the KV pages (same host link); the
            # pin keeps them from being evicted before the slot lands
            transfer_s += dst.swap_in(mid, now)
            dst.pin_model(mid)
        src.pages_migrated_out += n_pg
        rec = self._slot_rec.pop((src.node_id, slot.uid))
        rec.preemptions += 1
        self._migrations[slot.uid] = self._migrations.get(slot.uid, 0) + 1
        dst.inbound_inflight += 1      # blocks reaping until KV lands
        dst.inbound_pages += n_pg      # reserves capacity while in flight
        self.tracer.add_span("sim.migrate", now, now + transfer_s,
                             track=f"{src.node_id}/link", uid=slot.uid,
                             pages=n_pg, dst=dst.node_id)
        self._push(now + transfer_s, "migrate_enter",
                   (dst, slot, rec, n_pg))
        self.preempt_events.append(
            f"t={now:.2f}s uid={slot.uid} {src.node_id} -> {dst.node_id} "
            f"pages={n_pg} transfer={transfer_s * 1e3:.1f}ms")
        self._schedule_decode(src, now)
        self._maybe_reap(src, now)

    def _on_migrate_enter(self, dst: SimNode, slot, rec: RequestRecord,
                          n_pg: int, now: float) -> None:
        dst.inbound_inflight -= 1
        dst.inbound_pages -= n_pg      # reservation becomes occupancy
        if dst.failed:
            # pages were in flight TO a board that died: the KV is gone,
            # recompute from the prompt on whatever survives
            self._retry(rec, now, "crash_inflight")
            return
        dst.pages_migrated_in += n_pg
        mid = getattr(slot, "model_id", None)
        if dst.models is not None and mid is not None:
            dst.unpin_model(mid)
        rec.decode_node = dst.node_id
        self._finish(dst, dst.decode_advance(now), now)
        resumed = dst.resume_slot(slot)
        self._slot_rec[(dst.node_id, resumed.uid)] = rec
        dst.decode_admit(resumed, now)
        self._maybe_preempt(dst, now)
        self._schedule_decode(dst, now)

    def _finish(self, node: SimNode, slots, now: float) -> None:
        for slot in slots:
            rec = self._slot_rec.pop((node.node_id, slot.uid))
            rec.t_first_token = slot.t_first_token
            rec.t_done = now
            if rec.t_decode_enter is not None:
                # per-request track: concurrent slots on one board
                # would partially overlap on a shared track
                self.tracer.add_span("sim.decode", rec.t_decode_enter,
                                     now,
                                     track=f"{node.node_id}/u{slot.uid}",
                                     uid=slot.uid,
                                     gen_len=rec.req.gen_len)
            if slot.t_first_token is not None:
                self.tracer.add_instant(
                    "sim.first_token", slot.t_first_token,
                    track=f"{node.node_id}/u{slot.uid}", uid=slot.uid)
            if self.slo is not None:
                mon = self.slo.monitor
                if rec.ttft_s is not None:
                    mon.observe_ttft(rec.ttft_s, t=now)
                if rec.tpot_s is not None:
                    mon.observe_tpot(rec.tpot_s, t=now)
                self.slo.step(now)

    # -- fault injection & recovery ------------------------------------
    def _on_fault(self, ev: FaultEvent, now: float) -> None:
        node = self.injector.resolve(ev, self.nodes)
        if node is None:
            return                     # everything already dead
        self.injector.count(ev.kind)
        if ev.kind == "crash":
            self._crash_node(node, now)
            return
        # derate / link / transient all mutate live node state: settle
        # the decode integral first so past progress is priced at the
        # old rate, then bump the version so stale events are dropped
        self._finish(node, node.decode_advance(now), now)
        node.decode_version += 1
        if ev.kind == "derate":
            node.derate = ev.factor
            self.derates += 1
            self.fault_events.append(
                f"t={now:.2f}s {node.node_id} DERATE x{ev.factor:g}"
                + (f" for {ev.duration_s:.2f}s" if ev.duration_s else ""))
            self.tracer.add_span("sim.fault.derate", now,
                                 now + (ev.duration_s or 0.0),
                                 track=node.node_id, factor=ev.factor)
        elif ev.kind == "link":
            node.link_derate = ev.factor
            self.link_faults += 1
            self.fault_events.append(
                f"t={now:.2f}s {node.node_id} LINK x{ev.factor:g}"
                + (f" for {ev.duration_s:.2f}s" if ev.duration_s else ""))
            self.tracer.add_span("sim.fault.link", now,
                                 now + (ev.duration_s or 0.0),
                                 track=f"{node.node_id}/link",
                                 factor=ev.factor)
        elif ev.kind == "transient":
            # a dispatch hiccup: the board produces nothing for the
            # stall window, then resumes exactly where it was
            node.stall_until = max(node.stall_until,
                                   now + (ev.duration_s or 0.0))
            self.transients += 1
            self.fault_events.append(
                f"t={now:.2f}s {node.node_id} STALL "
                f"{(ev.duration_s or 0.0) * 1e3:.0f}ms")
            self.tracer.add_span("sim.fault.transient", now,
                                 now + (ev.duration_s or 0.0),
                                 track=node.node_id)
        if ev.kind in ("derate", "link") and ev.duration_s is not None:
            self._push(now + ev.duration_s, "fault_clear",
                       (ev.kind, node))
        self._schedule_decode(node, now)

    def _on_fault_clear(self, kind: str, node: SimNode,
                        now: float) -> None:
        if node.failed or node not in self.nodes:
            return
        self._finish(node, node.decode_advance(now), now)
        node.decode_version += 1
        if kind == "derate":
            node.derate = 1.0
        elif kind == "link":
            node.link_derate = 1.0
        self.fault_events.append(
            f"t={now:.2f}s {node.node_id} CLEAR {kind}")
        self._schedule_decode(node, now)
        self._maybe_reap(node, now)

    def _crash_node(self, node: SimNode, now: float) -> None:
        """Fail-stop: settle decode progress, mark the board dead, and
        recover its live work -- checkpointed lanes migrate their pages
        (replaying only tokens since the last checkpoint tick), the rest
        retry from the prompt.  Uptime/energy accounting stops here."""
        self._finish(node, node.decode_advance(now), now)
        node.failed = True
        node.draining = True
        node.decode_version += 1
        self.crashes += 1
        self.fault_events.append(f"t={now:.2f}s {node.node_id} CRASH")
        self.tracer.add_instant("sim.fault.crash", now,
                                track=node.node_id)
        if self.flight is not None:
            # black box: the ring holds the telemetry leading up to the
            # crash; dump it named for the dying board
            self.flight.dump(
                f"flight_{node.node_id.replace('/', '_')}.jsonl",
                reason=f"sim crash of {node.node_id} at t={now:.3f}s",
                registry=self.registry, t=now)
        if self.straggler_monitor is not None:
            host = self._host_idx.get(node.node_id)
            if host is not None:        # dead host must not skew the median
                self.straggler_monitor.reset(host)
                self._obs_last.pop(node.node_id, None)
        if node in self.nodes:          # stop routing + billing now
            self.nodes.remove(node)
            self.retired.append(node)
            self._retired_at[node.node_id] = now
        for slot in sorted(node.decode_active.values(),
                           key=lambda s: s.uid):
            rec = self._slot_rec.pop((node.node_id, slot.uid))
            self._recover_slot(node, slot, rec, now)
        node.decode_active.clear()
        for slot in list(node.decode_queue):
            rec = self._slot_rec.pop((node.node_id, slot.uid))
            self._retry(rec, now, "crash")
        node.decode_queue.clear()
        if node.prefill_active is not None:
            self._retry(node.prefill_active, now, "crash")
            node.prefill_active = None
        node.prefill_busy = False
        for rec in list(node.prefill_queue):
            if self._prefill_claimable(node, rec):
                self._retry(rec, now, "crash")
        node.prefill_queue.clear()

    def _recover_slot(self, node: SimNode, slot, rec: RequestRecord,
                      now: float) -> None:
        """One live lane of a crashed board: roll back to the last
        checkpoint tick and re-place it like a migration (the checkpoint
        lives host-side, so only the DESTINATION link is paid)."""
        ckpt = slot.ckpt_tokens if self.recovery is not None else None
        if ckpt is None:
            self.replayed_from_prompt += 1
            self._retry(rec, now, "crash_no_checkpoint")
            return
        slot.tokens_done = float(min(ckpt, slot.gen_len))
        if slot.tokens_done < 1.0:
            slot.t_first_token = None
        dst = self.router.route_migration(slot, node,
                                          self._routable(now), now)
        if dst is None:
            self.replayed_from_prompt += 1
            self._retry(rec, now, "crash_no_destination")
            return
        ctx = slot.prompt_len + int(slot.tokens_done)
        n_pg = node.migration_pages(ctx)
        transfer_s = dst.kv_page_transfer_s(n_pg)
        mid = getattr(slot, "model_id", None)
        if dst.models is not None and mid is not None:
            transfer_s += dst.swap_in(mid, now)
            dst.pin_model(mid)
        rec.preemptions += 1
        self._migrations[slot.uid] = self._migrations.get(slot.uid, 0) + 1
        self.recovered_lanes += 1
        dst.inbound_inflight += 1
        dst.inbound_pages += n_pg
        self.tracer.add_span("sim.recover", now, now + transfer_s,
                             track=f"{dst.node_id}/link", uid=slot.uid,
                             pages=n_pg, src=node.node_id)
        self._push(now + transfer_s, "migrate_enter",
                   (dst, slot, rec, n_pg))
        self.fault_events.append(
            f"t={now:.2f}s uid={slot.uid} RECOVER {node.node_id} -> "
            f"{dst.node_id} ckpt_tokens={int(slot.tokens_done)} "
            f"pages={n_pg}")

    def _on_checkpoint(self, now: float) -> None:
        """Periodic fleet-wide checkpoint tick: every live decode slot
        snapshots its progress (``ckpt_tokens``); a later crash rolls
        the slot back here instead of to the prompt."""
        for node in list(self.nodes):
            if node.failed:
                continue
            finished = node.decode_advance(now)
            if finished:
                self._finish(node, finished, now)
                self._schedule_decode(node, now)
                self._maybe_reap(node, now)
            # lint: ok R005 per-slot snapshot write, order-free
            for slot in node.decode_active.values():
                slot.ckpt_tokens = int(slot.tokens_done)
        self.checkpoints += 1
        if self._work_remains():
            self._push(now + self.recovery.checkpoint_interval_s,
                       "checkpoint", None)

    def _on_autoscale(self, now: float) -> None:
        if self.autoscaler is None:
            return
        self.scale_events.extend(self.autoscaler.tick(self, now))
        if self._work_remains():
            self._push(now + self.autoscaler.interval_s, "autoscale", None)

    # -- main loop ------------------------------------------------------
    def run(self) -> FleetReport:
        for rec in self.records:
            self._push(rec.req.arrival_s, "arrive", rec)
        if self.autoscaler is not None:
            self._push(self.autoscaler.interval_s, "autoscale", None)
        if self.injector is not None:
            for ev in self.injector.plan.sim_events():
                self._push(ev.at_s, "fault", ev)
        if self.recovery is not None:
            self._push(self.recovery.checkpoint_interval_s,
                       "checkpoint", None)
        now = 0.0
        while self._heap:
            now, _, kind, payload = heapq.heappop(self._heap)
            self._now = now            # the straggler monitor's clock
            if kind == "arrive":
                self._on_arrive(payload, now)
            elif kind == "prefill_done":
                self._on_prefill_done(payload[0], payload[1], now)
            elif kind == "prefill_free":
                self._on_prefill_free(payload, now)
            elif kind == "decode_enter":
                self._on_decode_enter(payload[0], payload[1], now,
                                      *payload[2:])
            elif kind == "decode":
                self._on_decode(payload[0], payload[1], now)
            elif kind == "migrate_enter":
                self._on_migrate_enter(payload[0], payload[1], payload[2],
                                       payload[3], now)
            elif kind == "autoscale":
                self._on_autoscale(now)
            elif kind == "fault":
                self._on_fault(payload, now)
            elif kind == "fault_clear":
                self._on_fault_clear(payload[0], payload[1], now)
            elif kind == "checkpoint":
                self._on_checkpoint(now)
            elif kind == "hedge":
                self._on_hedge(payload, now)
        return self._report(makespan=now)

    # -- metrics --------------------------------------------------------
    def _node_uptime_s(self, node: SimNode, makespan: float) -> float:
        t0 = self._added_at.get(node.node_id, 0.0)
        t1 = self._retired_at.get(node.node_id, makespan)
        return max(t1 - t0, 0.0)

    def _report(self, makespan: float) -> FleetReport:
        done = [r for r in self.records if r.done]
        makespan = max(makespan, 1e-9)
        ttft = np.array(sorted(r.ttft_s for r in done), np.float64)
        tpot = np.array(sorted(r.tpot_s for r in done), np.float64)

        def pct(arr, q):
            return float(np.percentile(arr, q)) if arr.size else float("nan")

        def meets_slo(r: RequestRecord) -> bool:
            if self.ttft_slo_s is not None and r.ttft_s > self.ttft_slo_s:
                return False
            if self.tpot_slo_s is not None and r.tpot_s > self.tpot_slo_s:
                return False
            return True

        energy = 0.0
        usd_hour = 0.0
        for node in self.nodes + self.retired:
            up = self._node_uptime_s(node, makespan)
            energy += node.energy_active_j + node.idle_energy_j(up)
            usd_hour += (capex_usd_per_hour(node.profile,
                                            self.amortization_years)
                         * up / makespan)
        avg_watts = energy / makespan
        usd_hour += energy_usd_per_hour(avg_watts, self.power_usd_per_kwh)
        gen_tok = sum(r.req.gen_len for r in done)
        gen_tok_s = gen_tok / makespan
        usd_per_mtok = usd_hour / max(gen_tok_s * 3600.0 / 1e6, 1e-9)
        good = sum(1 for r in done if meets_slo(r))
        # per-model decode accounting (tpot + tokens/joule), multi-model
        # traces only -- the nodes integrate per-model dynamic energy
        by_model: Dict[str, List[float]] = {}
        for r in done:
            mid = getattr(r.req, "model_id", None)
            if mid is not None:
                by_model.setdefault(mid, []).append(r.tpot_s)
        per_model = []
        for mid in sorted(by_model):
            toks = sum(n.model_tokens.get(mid, 0.0)
                       for n in self.nodes + self.retired)
            joules = sum(n.model_energy_j.get(mid, 0.0)
                         for n in self.nodes + self.retired)
            per_model.append((mid, pct(np.asarray(sorted(by_model[mid])), 50),
                              int(round(toks)),
                              toks / joules if joules > 0 else float("nan")))
        report = FleetReport(
            offered=len(self.records), completed=len(done),
            makespan_s=makespan,
            ttft_p50_s=pct(ttft, 50), ttft_p99_s=pct(ttft, 99),
            tpot_p50_s=pct(tpot, 50), tpot_p99_s=pct(tpot, 99),
            requests_per_s=len(done) / makespan,
            goodput_rps=good / makespan,
            gen_tokens_per_s=gen_tok_s,
            avg_watts=avg_watts, energy_j=energy,
            joules_per_request=(sum(r.energy_j for r in done) / len(done)
                                if done else float("nan")),
            usd_per_hour=usd_hour, usd_per_mtok=usd_per_mtok,
            preemptions=sum(n.preemptions
                            for n in self.nodes + self.retired),
            pages_migrated=sum(n.pages_migrated_out
                               for n in self.nodes + self.retired),
            model_swaps=sum(n.model_swaps
                            for n in self.nodes + self.retired),
            swap_bytes=sum(n.swap_bytes
                           for n in self.nodes + self.retired),
            per_model=tuple(per_model),
            scale_events=tuple(self.scale_events),
            preempt_events=tuple(self.preempt_events),
            swap_events=tuple(self.swap_events),
            crashes=self.crashes, derates=self.derates,
            link_faults=self.link_faults, transients=self.transients,
            retries=self.retries, hedges=self.hedges,
            requests_lost=self.requests_lost,
            recovered_lanes=self.recovered_lanes,
            replayed_from_prompt=self.replayed_from_prompt,
            checkpoints=self.checkpoints,
            fault_events=tuple(self.fault_events),
            derate_detected=tuple(self.derate_detected))
        # publish the aggregate report under the fleet.* namespace so
        # the sim's numbers sit next to the engines' in one exposition
        # lint: ok R005 dataclass field order, deterministic by construction
        for key, val in report.metrics().items():
            self.registry.gauge(f"fleet.{key}").set(float(val))
        return report
