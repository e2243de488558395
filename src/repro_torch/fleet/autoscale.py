"""Queue-depth-driven autoscaling over one pool of the simulated fleet.

A :class:`QueueDepthAutoscaler` watches one (profile, role) pool on a
fixed control interval and keeps its backlog-per-node between a low and
a high watermark: above the high mark it clones a node from the pool
template (cold-start delay included -- reclaimed boards still take time
to join), below the low mark it drains the least-loaded node.  Scale
decisions are pure functions of simulated state, so runs stay
deterministic.

Backlog metric: prefill-capable pools use the estimated FIFO wait in
units of one request's service time; decode-capable pools use resident
requests per lane.
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.fleet.node import SimNode
from repro_torch.fleet.sim import FleetSim, NodeSpec


@dataclasses.dataclass
class QueueDepthAutoscaler:
    """Scale ``template``'s pool between ``min_nodes`` and ``max_nodes``."""

    template: NodeSpec
    interval_s: float = 10.0
    high_depth: float = 2.0
    low_depth: float = 0.25
    min_nodes: int = 1
    max_nodes: int = 16
    cold_start_s: float = 30.0
    #: prompt length used to express prefill backlog in units of one
    #: request's service time -- set it to the workload's prompt_len.
    ref_prompt_len: int = 512

    def _pool(self, sim: FleetSim) -> List[SimNode]:
        return [n for n in sim.nodes
                if n.profile.name == self.template.profile
                and n.role == self.template.role and not n.draining]

    def _depth(self, node: SimNode, now: float) -> float:
        if node.role in ("decode", "both"):
            lane_depth = node.decode_load() / max(node.decode_lanes, 1)
            if node.kv_pool_pages is not None:
                # paged capacity is bytes: pressure is whichever binds
                # first, lanes or page-pool occupancy
                page_depth = (node.kv_pages_in_use()
                              / max(node.kv_pool_pages, 1))
                return max(lane_depth, page_depth)
            return lane_depth
        svc = node.prefill_service_s(self.ref_prompt_len)
        return node.est_prefill_wait_s(now) / max(svc, 1e-9)

    def tick(self, sim: FleetSim, now: float) -> List[str]:
        pool = self._pool(sim)
        if not pool:
            return []
        depth = sum(self._depth(n, now) for n in pool) / len(pool)
        if depth > self.high_depth and len(pool) < self.max_nodes:
            node = sim.add_node(self.template, now=now + self.cold_start_s)
            return [f"t={now:.1f}s depth={depth:.2f} +1 -> "
                    f"{node.node_id} (joins t={now + self.cold_start_s:.1f}s)"]
        if depth < self.low_depth and len(pool) > self.min_nodes:
            victim = min(pool, key=lambda n: (self._depth(n, now),
                                              n.node_id))
            sim.retire_node(victim, now)
            return [f"t={now:.1f}s depth={depth:.2f} -1 -> "
                    f"drain {victim.node_id}"]
        return []
