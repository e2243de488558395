"""Request routing policies over a heterogeneous node set.

The router makes two decisions per request: which node prefills it
(chosen at arrival) and which node decodes it (chosen when the KV is
ready, so the decision sees current decode load).  The prefill->decode
KV handoff cost -- the CMP 170HX's defining constraint, a PCIe 1.1 x4
link (~1 GB/s) -- is computed from the *bottleneck* endpoint via
``phase_model.kv_handoff_seconds`` and charged both to the prefill
board's occupancy and to the request's time-to-first-token.

Policies:

* :class:`LeastLoadedRouter` -- shortest backlog / fewest resident
  requests.  The throughput-oriented default.
* :class:`CostAwareRouter`   -- least incremental $ per useful token:
  prefers cheap reclaimed boards until their queues erase the price
  advantage.
* :class:`SLOAwareRouter`    -- minimizes predicted TTFT (prefill) and
  avoids nodes whose post-admission step time would breach the TPOT
  SLO (decode); falls back to least-loaded among violators.
* :class:`PreemptionAwareSLORouter` -- SLO routing plus an ANTICIPATED
  eviction-cost term: near-capacity nodes are charged the pages the
  fleet would later have to migrate, priced at the host-link transfer
  time, instead of reacting only after page exhaustion.

Multi-model fleets add an affinity dimension: every policy charges a
node that does not have the request's model resident the weight-swap
transfer time plus the page-pool shrinkage the swapped-in weights cause
(``model_affinity_penalty``) -- so a request routes to a node that
already has the model HOT whenever one exists with capacity, instead of
forcing a swap over the PCIe 1.1 x4 link.  Construct any router with
``model_aware=False`` to get the affinity-blind baseline.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.fleet.node import SimNode
from repro_torch.serving.phase_model import capex_usd_per_hour, energy_usd_per_hour


def _req_model(record) -> Optional[str]:
    return getattr(record.req, "model_id", None)


def prefill_candidates(nodes: Sequence[SimNode],
                       mid: Optional[str] = None) -> List[SimNode]:
    return [n for n in nodes if n.role in ("prefill", "both")
            and n.serves_model(mid) and not n.failed]


def decode_candidates(nodes: Sequence[SimNode],
                      mid: Optional[str] = None) -> List[SimNode]:
    return [n for n in nodes if n.role in ("decode", "both")
            and n.serves_model(mid) and not n.failed]


def kv_capacity_penalty(record, node: SimNode) -> float:
    """Additive decode-score penalty for a node whose page pool cannot
    hold the request: capacity is BYTES, not lanes, so a board with a
    free lane but a full pool must lose to one with pages to spare
    (spilling over the PCIe 1.1 x4 host link is ~1000x slower than HBM).
    Zero for nodes without a configured pool -- legacy scores unchanged.
    On a prefix-sharing board the over-commit probe discounts a request
    whose prefix family is already resident, so siblings gravitate to
    the board holding their template.
    """
    over = node.kv_overcommit(record.req.prompt_len, record.req.gen_len,
                              prefix_id=getattr(record.req, "prefix_id",
                                                None),
                              prefix_len=getattr(record.req, "prefix_len",
                                                 0))
    return 1e9 * over if over else 0.0


def kv_migration_penalty(ctx: int, remaining: float,
                         node: SimNode) -> float:
    """Same page-capacity penalty, expressed for a mid-stream slot
    (live context + remaining budget) instead of a fresh request."""
    over = node.kv_overcommit(ctx, int(remaining))
    return 1e9 * over if over else 0.0


def model_affinity_penalty(record, node: SimNode) -> float:
    """Additive score term for multi-model nodes: a node with the
    request's model HOT costs nothing; a cold node pays

    * the weight transfer over its host link (the swap itself), plus
    * the page-pool shrinkage those weights cause, priced as the
      host-link transfer time of the KV pages they displace beyond the
      node's spare headroom (the anticipated eviction cost of the
      decodes the shrink would push out),

    and is refused outright (1e9) when the displaced pages would leave
    the pool unable to hold the request itself.  Zero for model-blind
    nodes/requests -- legacy scores unchanged.
    """
    mid = _req_model(record)
    if mid is None or node.models is None:
        return 0.0
    swap_s = node.swap_in_s(mid)
    if swap_s == 0.0:
        return 0.0
    pages_lost = node.swap_pages(mid)
    if node.kv_pool_pages is None:
        return swap_s
    ctx = record.req.prompt_len + record.req.gen_len // 2
    need = -(-ctx // node.page_size) if ctx > 0 else 0
    free_after = node.kv_pages_free() - pages_lost
    if free_after < need:
        return 1e9
    headroom = max(node.kv_pages_free() - need, 0)
    displaced = max(pages_lost - headroom, 0)
    return swap_s + node.kv_page_transfer_s(displaced)


def anticipated_eviction_s(record, node: SimNode) -> float:
    """Seconds of KV-page migration this node is PROJECTED to pay if it
    also takes ``record``: residents' final contexts (plus the new
    request's) minus the pool, priced per page over the host link.
    Zero when the futures fit -- only near-capacity nodes are charged.
    """
    if node.kv_pool_pages is None:
        return 0.0
    final_ctx = record.req.prompt_len + record.req.gen_len
    need = max(-(-final_ctx // node.page_size), 1)
    overflow = max(node.kv_pages_projected() + need - node.kv_pool_pages, 0)
    return node.kv_page_transfer_s(overflow) if overflow else 0.0


class Router:
    """Base policy; subclasses override the two scoring hooks.

    ``model_aware=False`` drops the multi-model affinity term from all
    scores -- the baseline that swaps weights wherever load-balancing
    happens to point.
    """

    name = "base"
    model_aware = True

    def __init__(self, model_aware: bool = True):
        self.model_aware = model_aware

    def _affinity(self, record, node: SimNode) -> float:
        return model_affinity_penalty(record, node) if self.model_aware \
            else 0.0

    def route_prefill(self, record, nodes: Sequence[SimNode],
                      now: float) -> SimNode:
        cands = prefill_candidates(nodes, _req_model(record))
        assert cands, "no prefill-capable node in the fleet"
        chosen = min(cands, key=lambda n: (self._prefill_score(record, n, now)
                                           + self._affinity(record, n),
                                           n.node_id))
        chosen.note_prefill_routed(record, now)
        return chosen

    def route_decode(self, record, src: SimNode, nodes: Sequence[SimNode],
                     now: float) -> SimNode:
        cands = decode_candidates(nodes, _req_model(record))
        assert cands, "no decode-capable node in the fleet"
        # score ties break toward the prefill board itself: local decode
        # keeps the KV in HBM and pays no handoff (the planner's
        # colocated model assumes exactly this)
        return min(cands, key=lambda n: (self._decode_score(record, src, n,
                                                            now)
                                         + self._affinity(record, n),
                                         n is not src, n.node_id))

    def route_migration(self, slot, src: SimNode,
                        nodes: Sequence[SimNode], now: float):
        """Pick the board a preempted slot resumes on, or ``None``.

        Migration is only worth its page traffic when the destination
        actually has capacity: the score is the page-granular transfer
        time over the bottleneck host link (``ceil(ctx/page_size)``
        pages, the same units the engine checkpoint ships) plus the
        remaining decode time at the destination's current sharing
        level, with the page-capacity penalty on top.  A destination
        whose own pool cannot hold the context is refused outright --
        shipping KV into another over-committed board trades one spill
        for two plus a transfer.
        """
        mid = getattr(slot, "model_id", None)
        cands = [n for n in decode_candidates(nodes, mid) if n is not src]
        if not cands:
            return None
        ctx = slot.prompt_len + int(slot.tokens_done)
        remaining = max(slot.gen_len - slot.tokens_done, 0.0)
        n_pg = src.migration_pages(ctx)

        def score(n: SimNode) -> float:
            # a destination without the slot's model hot pays the
            # weight swap on top of the KV page transfer
            swap_s = n.swap_in_s(mid) if self.model_aware else 0.0
            return (src.kv_page_transfer_s(n_pg, peer=n.profile) + swap_s
                    + remaining * n.est_decode_step_s(ctx, extra=1, mid=mid)
                    + kv_migration_penalty(ctx, remaining, n))

        best = min(cands, key=lambda n: (score(n), n.node_id))
        if best.kv_overcommit(ctx, int(remaining)) > 0:
            return None
        return best

    # -- scoring hooks (lower wins) ------------------------------------
    def _prefill_score(self, record, node: SimNode, now: float) -> float:
        raise NotImplementedError

    def _decode_score(self, record, src: SimNode, node: SimNode,
                      now: float) -> float:
        raise NotImplementedError


class LeastLoadedRouter(Router):
    name = "least-loaded"

    def _prefill_score(self, record, node: SimNode, now: float) -> float:
        return node.est_prefill_wait_s(now)

    def _decode_score(self, record, src: SimNode, node: SimNode,
                      now: float) -> float:
        return float(node.decode_load()) + kv_capacity_penalty(record, node)


class CostAwareRouter(Router):
    """Minimize incremental $/token: (wait + service) x board $/s."""

    name = "cost-aware"

    def __init__(self, amortization_years: float = 3.0,
                 power_usd_per_kwh: float = 0.10,
                 model_aware: bool = True):
        super().__init__(model_aware=model_aware)
        self.amortization_years = amortization_years
        self.power_usd_per_kwh = power_usd_per_kwh

    def _usd_per_s(self, node: SimNode) -> float:
        capex = capex_usd_per_hour(node.profile, self.amortization_years)
        opex = energy_usd_per_hour(node.profile.tdp_watts,
                                   self.power_usd_per_kwh)
        return (capex + opex) / 3600.0

    def _prefill_score(self, record, node: SimNode, now: float) -> float:
        busy = (node.est_prefill_wait_s(now)
                + node.prefill_service_s(record.req.prompt_len,
                                         _req_model(record)))
        return busy * self._usd_per_s(node) / max(record.req.prompt_len, 1)

    def _decode_score(self, record, src: SimNode, node: SimNode,
                      now: float) -> float:
        ctx = record.req.prompt_len + record.req.gen_len // 2
        t_req = (record.req.gen_len
                 * node.est_decode_step_s(ctx, extra=1 + node.decode_load()
                                          - len(node.decode_active),
                                          mid=_req_model(record)))
        return (t_req * self._usd_per_s(node) / max(record.req.gen_len, 1)
                + kv_capacity_penalty(record, node))


class SLOAwareRouter(Router):
    """Route to minimize predicted TTFT / keep TPOT under the SLO."""

    name = "slo-aware"

    def __init__(self, ttft_slo_s: float = 2.0, tpot_slo_s: float = 0.2,
                 model_aware: bool = True):
        super().__init__(model_aware=model_aware)
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s

    def _prefill_score(self, record, node: SimNode, now: float) -> float:
        mid = _req_model(record)
        ttft = (node.est_prefill_wait_s(now)
                + node.prefill_service_s(record.req.prompt_len, mid)
                + node.prefill_handoff_s(record.req.prompt_len, mid=mid))
        return ttft

    def _decode_score(self, record, src: SimNode, node: SimNode,
                      now: float) -> float:
        ctx = record.req.prompt_len + record.req.gen_len // 2
        active = len(node.decode_active)
        queued = node.decode_load() - active
        # steady-state batch is capped by the lane count: queued work
        # waits, it does not run concurrently
        b = min(node.decode_lanes, active + queued + 1)
        step = node.est_decode_step_s(ctx, extra=max(b - active, 0),
                                      mid=_req_model(record))
        # SLO violators sort after every compliant node; among
        # compliant nodes deeper backlogs (longer queue wait) lose
        penalty = 1e6 if step > self.tpot_slo_s else 0.0
        penalty += kv_capacity_penalty(record, node)
        return penalty + step * (1.0 + queued / max(node.decode_lanes, 1))


class PreemptionAwareSLORouter(SLOAwareRouter):
    """SLO routing that ANTICIPATES eviction cost (the ROADMAP
    follow-on): instead of reacting only once a board's page pool is
    exhausted -- by which point the fleet is already paying a migration
    (``ceil(ctx/page_size)`` pages over the host link) -- the decode
    score charges each candidate the migration seconds its PROJECTED
    final occupancy implies.  A board whose residents' futures already
    fill the pool loses to a peer with headroom even while its present
    occupancy still looks fine, so the request that would have forced
    an eviction lands on the peer up front and the migration never
    happens.
    """

    name = "preempt-aware-slo"

    def __init__(self, ttft_slo_s: float = 2.0, tpot_slo_s: float = 0.2,
                 eviction_weight: float = 1.0, model_aware: bool = True):
        super().__init__(ttft_slo_s, tpot_slo_s, model_aware=model_aware)
        self.eviction_weight = eviction_weight

    def _decode_score(self, record, src: SimNode, node: SimNode,
                      now: float) -> float:
        base = super()._decode_score(record, src, node, now)
        return base + self.eviction_weight * anticipated_eviction_s(
            record, node)
