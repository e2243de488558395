"""A simulated serving node: one board, one role, one queue discipline.

A :class:`SimNode` wraps a :class:`~repro_torch.core.device_profile.DeviceProfile`
through the :class:`~repro_torch.core.perf_model.InferencePerfModel` and turns
its per-phase estimates into *service processes*:

* **prefill** -- a serial FIFO executor (compute-bound; batching prompts
  past saturation buys nothing on these boards).  A request occupies the
  node for ``prompt/tps`` of compute plus, when the KV must ship to
  another board, the interconnect handoff -- the same charge the static
  planner's ``effective_prefill_tps`` makes.
* **decode** -- lane-limited continuous batching modeled as processor
  sharing with a roofline step time: with ``B`` active lanes the node
  emits one token per lane every ``max(B*t_compute, t_weights +
  sum(t_kv_i))`` seconds -- weights stream once per step (shared),
  per-lane KV and MACs do not.  At ``B=1`` this reduces exactly to the
  planner's batch-1 decode estimate, which is what keeps the simulator
  and ``plan_fleet`` in steady-state agreement.

A ``role="both"`` node time-slices 50/50 between the phases (both rates
halved), mirroring the planner's seed split.

Paged KV occupancy (``kv_pool_pages``): mirrors the engine's page-pool
layout -- each resident decode slot occupies ``ceil(context /
page_size)`` pages, growing as it generates.  When the sum exceeds the
pool the board is over-committed and the overflow pages must stream
over the HOST link (PCIe 1.1 x4 on the CMP 170HX) instead of HBM: the
spilled share of the per-step KV traffic is slowed by the
``hbm_bw / interconnect_bw`` ratio, which on this board is ~3 orders of
magnitude -- the model's way of saying "don't over-commit".  Routers
consult :meth:`SimNode.kv_overcommit` to see capacity as bytes rather
than lanes; ``kv_pool_pages=None`` (default) disables the constraint
and reproduces the pre-paging behavior exactly.

Multi-model residency (``models=``): a node may host a CATALOG of
models, of which a subset is *resident* (weights in HBM).  Weights and
KV pages compete for the same ``hbm_gb`` budget -- ``kv_pool_pages``
becomes whatever the resident weights leave over -- and a request for a
non-resident model pays the weight transfer over the same PCIe 1.1 x4
host link the KV migrations cross (``swap_in``), LRU-evicting idle
resident models to make room.  Each distinct resident model serving the
decode batch streams its own weights once per step, so co-hosting
models on one board dilates the shared step time -- the cost the
router's affinity term weighs against the swap.

Energy: the node integrates board power over simulated time (idle floor
plus dynamic power scaled by instantaneous occupancy); each request is
additionally charged its solo-cost joules via
:func:`repro_torch.core.energy.request_energy_joules` -- per-model, so the
per-model tokens/joule accounting the power-aware benchmarking
motivates falls out of the report.
"""

from __future__ import annotations

import dataclasses
from typing import Deque, Dict, List, Optional, Sequence

from collections import deque

from repro_torch.core.device_profile import DeviceProfile
from repro_torch.core.energy import request_energy_joules
from repro_torch.core.perf_model import InferencePerfModel, LLMSpec, QWEN25_1P5B
from repro_torch.quant.formats import bytes_per_weight
from repro_torch.serving.phase_model import kv_handoff_seconds, link_transfer_seconds


def _bucket(n: int, step: int = 32) -> int:
    """Round a length to a cache bucket (exact for multiples of step)."""
    return max(step, int(round(n / step)) * step)


#: token-count slack for "generation finished" -- absorbs float drift in
#: the processor-sharing integration so completion events cannot
#: reschedule themselves with ~1e-16 token progress (a livelock).
_DONE_EPS = 1e-9


@dataclasses.dataclass
class DecodeSlot:
    """One request resident in the decode batch."""

    uid: int
    gen_len: int
    t_comp_s: float          # per-step MAC+epilogue time for this context
    t_kv_s: float            # per-step KV streaming time for this context
    dyn_j_per_tok: float     # dynamic (above-idle) joules per token
    prompt_len: int = 0      # live context = prompt_len + tokens_done
    tokens_done: float = 0.0
    t_first_token: Optional[float] = None
    model_id: Optional[str] = None
    #: per-step weight-stream time of THIS slot's model -- paid once per
    #: step per distinct resident model in the batch, not per lane
    t_weights_s: float = 0.0
    #: tokens covered by the last host-side lane checkpoint (None: no
    #: checkpoint interval has elapsed yet).  On a node crash the slot
    #: resumes from here -- tokens past it are lost with the board's HBM
    ckpt_tokens: Optional[int] = None
    #: prompt-prefix family (see ``FleetRequest``): on a prefix-sharing
    #: board the family's full prefix pages are physical ONCE no matter
    #: how many resident slots open with them
    prefix_id: Optional[int] = None
    prefix_len: int = 0


class SimNode:
    """One simulated board with a role and queues (see module docstring)."""

    def __init__(self, node_id: str, profile: DeviceProfile, role: str,
                 fmt: str, spec: LLMSpec = QWEN25_1P5B,
                 decode_lanes: int = 1, page_size: int = 16,
                 kv_pool_pages: Optional[int] = None,
                 models: Optional[Dict[str, LLMSpec]] = None,
                 resident_models: Optional[Sequence[str]] = None,
                 hbm_gb: Optional[float] = None,
                 weight_fmt: Optional[str] = None,
                 prefix_sharing: bool = False):
        assert role in ("prefill", "decode", "both"), role
        self.node_id = node_id
        self.profile = profile
        self.role = role
        self.fmt = fmt
        self.spec = spec
        self.decode_lanes = decode_lanes
        self.page_size = page_size
        #: model the engine's copy-on-write prefix cache: resident slots
        #: of one prefix family share the family's full prefix pages
        self.prefix_sharing = prefix_sharing
        self._kv_pool_pages_static = kv_pool_pages
        self._model = InferencePerfModel(profile, spec)
        # multi-model catalog: per-model perf models + weight bytes, a
        # resident subset, and (optionally) one HBM byte budget that
        # weights and KV pages share
        self.models = dict(models) if models else None
        self._weight_fmt = weight_fmt or fmt
        if self.models:
            self._perf = {m: InferencePerfModel(profile, s)
                          for m, s in self.models.items()}
            self._weight_bytes = {
                m: s.params_total * bytes_per_weight(self._weight_fmt)
                for m, s in self.models.items()}
            keep = (list(resident_models) if resident_models is not None
                    else list(self.models))
            self.resident_models: Dict[str, float] = {m: 0.0 for m in keep}
        else:
            self._perf = {}
            self._weight_bytes = {}
            self.resident_models = {}
        self._hbm_bytes = hbm_gb * 1e9 if hbm_gb is not None else None
        # pages are token-denominated and SHARED across models, so a
        # multi-model board prices them conservatively at the largest
        # catalog model's KV row -- capacity is never overcounted
        kv_tok = spec.kv_bytes_per_token()
        if self.models:
            kv_tok = max([kv_tok] + [s.kv_bytes_per_token()
                                     for s in self.models.values()])
        self._page_bytes = page_size * kv_tok
        self._model_pins: Dict[str, int] = {}   # weights en route: no evict
        self.model_swaps = 0
        self.swap_bytes = 0.0
        self.model_evictions = 0
        self.model_tokens: Dict[str, float] = {}   # decoded tokens by model
        self.model_energy_j: Dict[str, float] = {}  # dynamic joules by model
        self._split = 0.5 if role == "both" else 1.0
        self._idle_w = InferencePerfModel.IDLE_FRACTION * profile.tdp_watts
        # caches keyed by (model, bucketed length/context)
        self._prefill_cache: Dict[tuple, tuple] = {}
        self._decode_cache: Dict[tuple, tuple] = {}
        self._req_energy_cache: Dict[tuple, float] = {}
        self._t_weights = 0.0    # per-step weight-stream time (ctx-free)
        # prefill FIFO state
        self.prefill_queue: Deque = deque()
        self.prefill_active: Optional[object] = None
        # True through compute AND the KV-handoff occupancy window --
        # the next queued request must not start until the KV has left
        self.prefill_busy = False
        self._prefill_backlog_s = 0.0
        self._backlog_asof = 0.0
        # decode processor-sharing state
        self.decode_active: Dict[int, DecodeSlot] = {}
        self.decode_queue: Deque[DecodeSlot] = deque()
        self._decode_last_t = 0.0
        self.decode_version = 0   # invalidates stale scheduled events
        # fault state (driven by repro_torch.fleet.faults via the sim)
        self.failed = False        # crashed: permanently unroutable
        self.derate = 1.0          # compute/thermal time dilation (>= 1)
        self.link_derate = 1.0     # host-link time dilation (>= 1)
        self.stall_until = 0.0     # transient stall window end (sim clock)
        # fleet membership (set by the sim / autoscaler)
        self.draining = False
        self.available_at = 0.0   # cold-start: unroutable before this
        self.inbound_inflight = 0  # KV transfers en route to this node
        # pages promised to migrations still crossing the link: counted
        # against free capacity so a burst of evictions cannot route
        # more contexts here than the pool can hold when they land
        self.inbound_pages = 0
        # accounting
        self.energy_active_j = 0.0   # above-idle joules
        self.prefill_busy_s = 0.0
        self.tokens_prefilled = 0
        self.tokens_decoded = 0
        self.kv_pages_hwm = 0        # peak page occupancy observed
        self.kv_spill_events = 0     # over-commit transitions
        self._spilled = False
        self.preemptions = 0         # slots evicted mid-decode here
        self.pages_migrated_out = 0  # KV pages shipped off this board
        self.pages_migrated_in = 0   # KV pages landed from elsewhere

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def bind_registry(self, registry) -> None:
        """Publish this board's counters as live callback gauges under
        ``fleet.node.<id>.*`` (read-through: the sim hot path pays
        nothing for being observable).  Note ``kv_spill_events`` here is
        the SIM's over-commit transition counter -- a distinct event
        from the engine's ``serve.kv.admit_blocked``."""
        prefix = f"fleet.node.{self.node_id}"
        for attr, help_text in (
                ("tokens_prefilled", "prompt tokens prefilled here"),
                ("tokens_decoded", "tokens decoded here"),
                ("kv_pages_hwm", "peak page occupancy observed"),
                ("kv_spill_events", "page-pool over-commit transitions"),
                ("preemptions", "slots evicted mid-decode here"),
                ("pages_migrated_out", "KV pages shipped off this board"),
                ("pages_migrated_in", "KV pages landed from elsewhere"),
                ("model_swaps", "weight loads over the host link"),
                ("swap_bytes", "weight bytes those swaps moved"),
                ("model_evictions", "weight sets LRU-evicted"),
                ("energy_active_j", "above-idle joules integrated")):
            registry.gauge(f"{prefix}.{attr}",
                           fn=(lambda a=attr: getattr(self, a)),
                           help=help_text)

    # ------------------------------------------------------------------
    # multi-model residency: weights vs KV pages in one HBM budget
    # ------------------------------------------------------------------
    def _hbm_after_weights(self) -> float:
        """Budget bytes the resident weights leave for KV -- negative
        when the weights alone over-commit the board."""
        return self._hbm_bytes - sum(self._weight_bytes[m]
                                     for m in self.resident_models)

    @property
    def kv_pool_pages(self) -> Optional[int]:
        """Pages the KV pool holds.  With an ``hbm_gb`` budget this is
        whatever the RESIDENT weights leave over (the multi-model
        trade-off); otherwise the statically configured count."""
        if self._hbm_bytes is None:
            return self._kv_pool_pages_static
        return max(int(self._hbm_after_weights() // self._page_bytes), 0)

    def _spec_for(self, mid: Optional[str]) -> LLMSpec:
        if mid is not None and self.models and mid in self.models:
            return self.models[mid]
        return self.spec

    def _perf_for(self, mid: Optional[str]) -> InferencePerfModel:
        if mid is not None and mid in self._perf:
            return self._perf[mid]
        return self._model

    def serves_model(self, mid: Optional[str]) -> bool:
        """Whether this node can host requests for ``mid`` at all."""
        return mid is None or self.models is None or mid in self.models

    def model_resident(self, mid: Optional[str]) -> bool:
        return (mid is None or self.models is None
                or mid in self.resident_models)

    def model_weight_bytes(self, mid: str) -> float:
        return self._weight_bytes[mid]

    def swap_pages(self, mid: str) -> int:
        """KV pages the model's weights displace from the shared pool."""
        return int(-(-self._weight_bytes[mid] // self._page_bytes))

    def swap_in_s(self, mid: Optional[str]) -> float:
        """Seconds a swap for ``mid`` would spend on the host link
        (0 when already resident) -- the router's estimate, no mutation."""
        if self.model_resident(mid):
            return 0.0
        return (link_transfer_seconds(self.profile, self._weight_bytes[mid])
                * self.link_derate)

    def pin_model(self, mid: str) -> None:
        """Weights (or a request) are en route for ``mid``: not evictable."""
        self._model_pins[mid] = self._model_pins.get(mid, 0) + 1

    def unpin_model(self, mid: str) -> None:
        self._model_pins[mid] = self._model_pins.get(mid, 0) - 1

    def _model_in_use(self, mid: str) -> bool:
        if self._model_pins.get(mid, 0) > 0:
            return True
        if any(s.model_id == mid for s in self.decode_active.values()):
            return True
        if any(s.model_id == mid for s in self.decode_queue):
            return True
        rec = self.prefill_active
        if rec is not None and getattr(rec.req, "model_id", None) == mid:
            return True
        return any(getattr(r.req, "model_id", None) == mid
                   for r in self.prefill_queue)

    def swap_in(self, mid: Optional[str], now: float) -> float:
        """Make ``mid`` resident; returns the modeled weight-transfer
        seconds (0 when already hot).  Idle resident models are LRU-
        evicted while the pool is over-committed -- a model with live
        slots (or pinned by an in-flight swap) is never evicted, so a
        board can end up page-starved instead, which the spill factor
        and the preemption policy then punish."""
        if self.model_resident(mid):
            if mid in self.resident_models:
                self.resident_models[mid] = now
            return 0.0
        t = (link_transfer_seconds(self.profile, self._weight_bytes[mid])
             * self.link_derate)
        self.resident_models[mid] = now
        self.model_swaps += 1
        self.swap_bytes += self._weight_bytes[mid]
        while self._hbm_bytes is not None and (
                self._hbm_after_weights() < 0 or self.kv_pages_free() < 0):
            cand = [m for m in self.resident_models
                    if m != mid and not self._model_in_use(m)]
            if not cand:
                break
            victim = min(cand, key=lambda m: (self.resident_models[m], m))
            del self.resident_models[victim]
            self.model_evictions += 1
        return t

    # ------------------------------------------------------------------
    # phase-estimate caches
    # ------------------------------------------------------------------
    def _prefill_est(self, prompt_len: int, mid: Optional[str] = None):
        key = (mid, _bucket(prompt_len))
        if key not in self._prefill_cache:
            est = self._perf_for(mid).prefill(self.fmt, key[1])
            self._prefill_cache[key] = (est.tokens_per_s, est.watts)
        return self._prefill_cache[key]

    def _decode_parts(self, context: int, mid: Optional[str] = None):
        """(t_compute, t_weights, t_kv, dyn_j_per_tok) per decode step."""
        key = (mid, _bucket(context))
        if key not in self._decode_cache:
            perf = self._perf_for(mid)
            est0 = perf.decode(self.fmt, context=0)
            est = perf.decode(self.fmt, context=key[1])
            t_comp = est.t_mac_s + est.t_epilogue_s
            t_w = est0.t_memory_s
            t_kv = est.t_memory_s - t_w
            step1 = max(t_comp, t_w + t_kv)
            dyn_j = max(est.watts - self._idle_w, 0.0) * step1
            if mid is None:
                self._t_weights = t_w
            self._decode_cache[key] = (t_comp, t_w, t_kv, dyn_j)
        return self._decode_cache[key]

    def request_energy_j(self, prompt_len: int, gen_len: int,
                         phase: str, mid: Optional[str] = None) -> float:
        """Solo-cost joules of running ``phase`` of a request here."""
        key = (prompt_len, gen_len, phase, mid)
        if key not in self._req_energy_cache:
            self._req_energy_cache[key] = request_energy_joules(
                self.profile, prompt_len, gen_len, self.fmt,
                self._spec_for(mid), phase=phase)
        return self._req_energy_cache[key]

    # ------------------------------------------------------------------
    # prefill: serial FIFO
    # ------------------------------------------------------------------
    def prefill_service_s(self, prompt_len: int,
                          mid: Optional[str] = None) -> float:
        tps, _ = self._prefill_est(prompt_len, mid)
        return prompt_len / (tps * self._split) * self.derate

    def prefill_handoff_s(self, prompt_len: int,
                          peer: Optional[DeviceProfile] = None,
                          mid: Optional[str] = None) -> float:
        return kv_handoff_seconds(self.profile, prompt_len,
                                  self._spec_for(mid),
                                  peer=peer) * self.link_derate

    def est_prefill_wait_s(self, now: float) -> float:
        """Backlog ahead of a newly routed request (router's estimate)."""
        wait = max(self._prefill_backlog_s - (now - self._backlog_asof), 0.0)
        return wait

    def note_prefill_routed(self, record, now: float) -> None:
        """Track virtual backlog so routers see in-flight commitments."""
        mid = getattr(record.req, "model_id", None)
        svc = self.prefill_service_s(record.req.prompt_len, mid)
        hand = self.prefill_handoff_s(record.req.prompt_len, mid=mid)
        self._prefill_backlog_s = (self.est_prefill_wait_s(now)
                                   + svc + hand + self.swap_in_s(mid))
        self._backlog_asof = now

    def start_prefill(self, record, now: float) -> float:
        """Begin compute for ``record``; returns the compute-done time.

        A non-resident model's weights cross the host link FIRST (the
        swap extends this request's occupancy window -- prefill cannot
        start without the weights)."""
        mid = getattr(record.req, "model_id", None)
        swap_s = self.swap_in(mid, now) if self.models else 0.0
        svc = self.prefill_service_s(record.req.prompt_len, mid) + swap_s
        _, watts = self._prefill_est(record.req.prompt_len, mid)
        self.prefill_active = record
        self.prefill_busy = True
        self.prefill_busy_s += svc
        self.energy_active_j += max(watts - self._idle_w, 0.0) * svc
        self.tokens_prefilled += record.req.prompt_len
        return now + svc

    # ------------------------------------------------------------------
    # decode: lane-limited processor sharing + page-pool occupancy
    # ------------------------------------------------------------------
    def _prefix_pages(self, prefix_len: int) -> int:
        """Full pages a prefix family can share (the engine never
        shares a partial tail page for good: CoW copies it on the
        consumer's first append)."""
        return max(int(prefix_len), 0) // self.page_size

    def _slot_shared(self, slot: DecodeSlot) -> int:
        """Pages of ``slot`` served from its family's shared prefix --
        capped so every slot keeps at least one private page (the
        engine's admission reserve: the live tail is always written)."""
        if not self.prefix_sharing or slot.prefix_id is None:
            return 0
        ctx = slot.prompt_len + int(slot.tokens_done)
        total = max(-(-ctx // self.page_size), 1)
        return min(self._prefix_pages(slot.prefix_len), total - 1)

    def _slot_pages(self, slot: DecodeSlot) -> int:
        """PRIVATE pages a resident slot occupies at its CURRENT live
        context.  Shared prefix pages are charged once per resident
        family (:meth:`_resident_prefix_pages`), not per slot -- the
        copy-on-write cache's whole capacity win."""
        ctx = slot.prompt_len + int(slot.tokens_done)
        return max(-(-ctx // self.page_size), 1) - self._slot_shared(slot)

    def _resident_prefix_pages(self) -> int:
        """One physical page charge per DISTINCT resident prefix
        family, however many slots opened with it."""
        fams: Dict[int, int] = {}
        for s in self.decode_active.values():
            shared = self._slot_shared(s)
            if shared:
                fams[s.prefix_id] = max(fams.get(s.prefix_id, 0), shared)
        return sum(fams.values())

    def kv_pages_in_use(self) -> int:
        return (sum(self._slot_pages(s)
                    for s in self.decode_active.values())
                + self._resident_prefix_pages())

    def kv_pages_free(self) -> int:
        """Free pages net of in-flight migration reservations (negative
        when over-committed); unbounded when no pool is configured."""
        if self.kv_pool_pages is None:
            return 1 << 30
        return (self.kv_pool_pages - self.kv_pages_in_use()
                - self.inbound_pages)

    def kv_bytes_free(self) -> float:
        """Router-facing capacity in BYTES, the paged-cache currency."""
        return (self.kv_pages_free() * self.page_size
                * self.spec.kv_bytes_per_token())

    def kv_pages_projected(self) -> int:
        """Pages the CURRENT residents will occupy at their FINAL
        contexts (plus in-flight reservations) -- what an anticipatory
        router scores instead of today's occupancy: a board that fits
        now but cannot fit its residents' futures is a migration (pages
        x transfer time over the host link) waiting to happen."""
        final = 0
        fams: Dict[int, int] = {}
        for s in self.decode_active.values():
            pages = max(-(-(s.prompt_len + s.gen_len)
                          // self.page_size), 1)
            shared = 0
            if self.prefix_sharing and s.prefix_id is not None:
                shared = min(self._prefix_pages(s.prefix_len), pages - 1)
                fams[s.prefix_id] = max(fams.get(s.prefix_id, 0), shared)
            final += pages - shared
        return final + sum(fams.values()) + self.inbound_pages

    def kv_overcommit(self, prompt_len: int = 0, gen_len: int = 0,
                      prefix_id: Optional[int] = None,
                      prefix_len: int = 0) -> int:
        """Pages by which admitting such a request (at its steady-state
        mid-generation context) would exceed the pool; 0 if it fits or
        no pool is configured.  A prefix-sharing board discounts the
        request's full prefix pages when its family is already resident
        -- routers therefore see the cache's EFFECTIVE capacity, and
        steer prefix siblings onto the boards that already hold their
        template."""
        if self.kv_pool_pages is None:
            return 0
        ctx = prompt_len + gen_len // 2
        need = -(-ctx // self.page_size) if ctx > 0 else 0
        if (need > 1 and self.prefix_sharing and prefix_id is not None
                and any(s.prefix_id == prefix_id
                        for s in self.decode_active.values())):
            need -= min(self._prefix_pages(prefix_len), need - 1)
        return max(need - self.kv_pages_free(), 0)

    # ------------------------------------------------------------------
    # preemption / migration: page-granular KV transfer over the host link
    # ------------------------------------------------------------------
    def migration_pages(self, context: int) -> int:
        """Pages a migration must ship for a live ``context`` -- KV
        moves in page units (``ceil(ctx / page_size)``), the same
        transfer unit the engine's :class:`LaneCheckpoint` captures."""
        return max(-(-int(context) // self.page_size), 1)

    def kv_page_transfer_s(self, n_pages: int,
                           peer: Optional[DeviceProfile] = None) -> float:
        """Seconds to move ``n_pages`` of KV over the host link,
        bottlenecked by the slower endpoint when ``peer`` is given --
        on the CMP 170HX both directions are strangled by the PCIe 1.1
        x4 link (~1 GB/s), which is the whole migration trade-off."""
        return kv_handoff_seconds(self.profile, n_pages * self.page_size,
                                  self.spec, peer=peer) * self.link_derate

    def preempt_slot(self, uid: int, now: float) -> DecodeSlot:
        """Evict a resident slot mid-stream: advance everyone to ``now``
        first so the slot leaves with its exact token progress, then
        remove it (promoting queued work into the freed lane)."""
        self.decode_advance(now)
        # queued slots occupy no pages and are never migration victims
        assert uid in self.decode_active, f"preempt of non-resident {uid}"
        slot = self.decode_active.pop(uid)
        while (self.decode_queue
               and len(self.decode_active) < self.decode_lanes):
            nxt = self.decode_queue.popleft()
            self.decode_active[nxt.uid] = nxt
        self.decode_version += 1
        self.preemptions += 1
        self._note_occupancy()
        return slot

    def resume_slot(self, slot: DecodeSlot) -> DecodeSlot:
        """Clone a preempted slot for residence HERE: identity and token
        progress carry over; the per-step compute/KV costs are
        re-estimated for this board at the resumed mid-generation
        context (the remaining tokens' steady-state view)."""
        done = int(slot.tokens_done)
        ctx = slot.prompt_len + done + max(slot.gen_len - done, 0) // 2
        t_comp, t_w, t_kv, dyn_j = self._decode_parts(max(ctx, 1),
                                                      slot.model_id)
        # a resumed slot holds EXCLUSIVE pages: the engine's evict
        # deep-copies shared prefix pages into the checkpoint and
        # restore re-anchors onto fresh ones, so the prefix discount
        # does not survive a migration
        return DecodeSlot(uid=slot.uid, gen_len=slot.gen_len,
                          t_comp_s=t_comp, t_kv_s=t_kv,
                          dyn_j_per_tok=dyn_j,
                          prompt_len=slot.prompt_len,
                          tokens_done=slot.tokens_done,
                          t_first_token=slot.t_first_token,
                          model_id=slot.model_id, t_weights_s=t_w,
                          ckpt_tokens=slot.ckpt_tokens)

    def _spill_factor(self) -> float:
        """Multiplier on the KV-stream term when over-committed: the
        overflow share of pages streams over the host link instead of
        HBM."""
        if self.kv_pool_pages is None:
            return 1.0
        in_use = self.kv_pages_in_use()
        if in_use <= self.kv_pool_pages:
            return 1.0
        spilled = (in_use - self.kv_pool_pages) / in_use
        link_ratio = (self.profile.hbm_bw_gbps
                      / max(self.profile.total_interconnect_gbps(), 1e-9))
        return 1.0 + spilled * (link_ratio - 1.0)

    def _note_occupancy(self) -> None:
        """Track page high-water mark and over-commit transitions."""
        in_use = self.kv_pages_in_use()
        self.kv_pages_hwm = max(self.kv_pages_hwm, in_use)
        over = (self.kv_pool_pages is not None
                and in_use > self.kv_pool_pages)
        if over and not self._spilled:
            self.kv_spill_events += 1
        self._spilled = over

    def _weights_stream_s(self, extra: Dict[Optional[str], float]) -> float:
        """Per-step weight-stream time: each DISTINCT model in the
        decode batch streams its weights once per step (co-hosting two
        models on one board pays both streams).  ``extra`` maps model
        ids a caller hypothetically adds to their weight times."""
        per_model: Dict[Optional[str], float] = {
            s.model_id: s.t_weights_s if s.model_id is not None
            else (s.t_weights_s or self._t_weights)
            for s in self.decode_active.values()}
        per_model.update(extra)
        if not per_model:
            return self._t_weights
        return sum(per_model.values())

    def _step_time_s(self) -> float:
        """Current per-token step time shared by all active lanes.

        Per-lane MACs and KV reads accumulate across the batch; each
        distinct model's weight stream is paid once per step (the
        continuous-batching bandwidth saving -- diluted when several
        models co-reside).  An over-committed page pool slows the KV
        term by the spilled share's host-link penalty.
        """
        if not self.decode_active:
            return 0.0
        comp_sum = sum(s.t_comp_s for s in self.decode_active.values())
        kv_sum = sum(s.t_kv_s for s in self.decode_active.values())
        kv_sum *= self._spill_factor()
        return (max(comp_sum, self._weights_stream_s({}) + kv_sum)
                / self._split * self.derate)

    def decode_load(self) -> int:
        return len(self.decode_active) + len(self.decode_queue)

    def est_decode_step_s(self, context: int, extra: int = 1,
                          mid: Optional[str] = None) -> float:
        """Predicted step time if ``extra`` more such lanes were active."""
        t_comp, t_w, t_kv, _ = self._decode_parts(context, mid)
        comp_sum = sum(s.t_comp_s for s in self.decode_active.values())
        kv_sum = sum(s.t_kv_s for s in self.decode_active.values())
        comp_sum += extra * t_comp
        kv_sum += extra * t_kv
        kv_sum *= self._spill_factor()
        t_weights = self._weights_stream_s({mid: t_w})
        return (max(comp_sum, t_weights + kv_sum)
                / self._split * self.derate)

    def make_slot(self, uid: int, prompt_len: int, gen_len: int,
                  model_id: Optional[str] = None,
                  prefix_id: Optional[int] = None,
                  prefix_len: int = 0) -> DecodeSlot:
        context = prompt_len + gen_len // 2
        t_comp, t_w, t_kv, dyn_j = self._decode_parts(context, model_id)
        return DecodeSlot(uid=uid, gen_len=gen_len, t_comp_s=t_comp,
                          t_kv_s=t_kv, dyn_j_per_tok=dyn_j,
                          prompt_len=prompt_len, model_id=model_id,
                          t_weights_s=t_w, prefix_id=prefix_id,
                          prefix_len=prefix_len)

    def decode_admit(self, slot: DecodeSlot, now: float) -> bool:
        """Returns True if the slot went active (else queued)."""
        if slot.model_id is not None and slot.model_id in self.resident_models:
            self.resident_models[slot.model_id] = now   # LRU touch
        self.decode_advance(now)
        if len(self.decode_active) < self.decode_lanes:
            self.decode_active[slot.uid] = slot
            self.decode_version += 1
            self._note_occupancy()
            return True
        self.decode_queue.append(slot)
        return False

    def decode_advance(self, now: float) -> List[DecodeSlot]:
        """Progress active lanes to ``now``; returns newly finished slots.

        A transient-fault stall window (``stall_until``) produces no
        tokens: the overlap with [last_t, now] is excised from the
        integration interval."""
        run_start = self._decode_last_t
        if self.stall_until > run_start:
            run_start = min(self.stall_until, now)
        dt = now - run_start
        if dt <= 0 or not self.decode_active:
            self._decode_last_t = max(self._decode_last_t, now)
            return []
        step = self._step_time_s()
        rate = 1.0 / step
        finished: List[DecodeSlot] = []
        for slot in self.decode_active.values():
            before = slot.tokens_done
            slot.tokens_done = min(before + rate * dt, float(slot.gen_len))
            advanced = slot.tokens_done - before
            if slot.t_first_token is None and slot.tokens_done >= 1.0:
                slot.t_first_token = run_start + (1.0 - before) * step
            self.energy_active_j += slot.dyn_j_per_tok * advanced
            self.tokens_decoded += advanced
            if slot.model_id is not None:
                self.model_tokens[slot.model_id] = (
                    self.model_tokens.get(slot.model_id, 0.0) + advanced)
                self.model_energy_j[slot.model_id] = (
                    self.model_energy_j.get(slot.model_id, 0.0)
                    + slot.dyn_j_per_tok * advanced)
            if slot.tokens_done >= slot.gen_len - _DONE_EPS:
                slot.tokens_done = float(slot.gen_len)
                finished.append(slot)
        for slot in finished:
            del self.decode_active[slot.uid]
        while (self.decode_queue
               and len(self.decode_active) < self.decode_lanes):
            nxt = self.decode_queue.popleft()
            self.decode_active[nxt.uid] = nxt
        if finished:
            self.decode_version += 1
        self._note_occupancy()
        self._decode_last_t = now
        return finished

    def decode_next_event_s(self, now: float) -> Optional[float]:
        """Absolute time of the next lane completion (None if idle)."""
        if not self.decode_active:
            return None
        step = self._step_time_s()
        remaining = min(slot.gen_len - slot.tokens_done
                        for slot in self.decode_active.values())
        return max(now, self.stall_until) + max(remaining, 0.0) * step

    # ------------------------------------------------------------------
    def idle_energy_j(self, duration_s: float) -> float:
        return self._idle_w * duration_s

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SimNode({self.node_id}, {self.profile.name}, "
                f"role={self.role})")
