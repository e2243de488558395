"""Multi-model serving on one HBM budget: weights page over the host link.

Port of the reference's ``serving/modelpool.py``.  The paper's board is
defined by two scarcities -- 8 GB of HBM2e and a PCIe 1.1 x4 host link
(~1 GB/s) -- so hosting *several* small models on one CMP 170HX means
weight bytes and KV pages compete for the same HBM and every model swap
crawls over the same link the KV-page migrations cross.  This module is
that economy made explicit:

* :class:`ModelPool` owns ONE byte budget per board.  Registered models
  (``ModelConfig`` + params, quantized or dense) are *resident* or
  *paged out*; ``load`` prices the weight transfer over the host link
  of the pool's :class:`~repro_torch.core.device_profile.DeviceProfile`
  (:func:`~repro_torch.serving.phase_model.link_transfer_seconds`) and
  ``unload`` is free (weights are clean: the master copy lives in host
  RAM, nothing writes back).
* :class:`MultiModelServeEngine` hosts one paged
  :class:`~repro_torch.serving.engine.ServeEngine` per resident model.
  Every engine's KV :class:`~repro_torch.serving.engine.PagePool` is
  carved from the shared budget: loading another model's weights
  ``shrink``\\ s the free pages of the least-recently-used residents, and
  unloading ``grow``\\ s them back toward the dense target -- weight
  residency and KV capacity trade off, page by page.

Residency is real on the card: the registry keeps each model's host
master copy, ``ensure_resident`` copies the weights to the device and
builds the engine over that copy, and an unload drops the engine with
its KV cache, its captured graphs (released before any later capture,
so no graph is destroyed mid-capture) and its device weights, so the
budget describes device memory the models actually hold.  As in the
reference, each engine's physical page array is allocated at the dense
target and its pool shrunk to the budget, so the device holds
``n_disabled`` pages more than the budget charges (:meth:`
MultiModelServeEngine.physical_kv_bytes`).  On the CPU the engines
serve the registry's tensors themselves.

Exactness contract: a model's token streams under multi-model serving
are bit-identical to the same requests served alone by a single-model
``ServeEngine`` with the same config, seed and temperature: each inner
engine is a real ServeEngine, requests are admitted per-model FIFO, and
an unload preserves the engine's admission counter so a reload
continues the exact sampling lineage.

Pinning: a model serving live lanes is never unloaded -- eviction only
considers idle residents, LRU first.  Shrinking only retires pages that
are free AND unpromised, so in-flight lanes keep their reservations.
"""

from __future__ import annotations

import dataclasses
import gc
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import torch

from repro_torch.analysis.invariants import invariant
from repro_torch.core.device_profile import DeviceProfile, get_profile
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import LM, paged_capacity
from repro_torch.obs.metrics import MetricsRegistry, StatsView
from repro_torch.obs.trace import SpanTracer
from repro_torch.serving.engine import (QuantizedParams, Request,
                                        ServeEngine,
                                        prefix_sharing_supported)
from repro_torch.serving.phase_model import link_transfer_seconds
from repro_torch.serving.resilience import AdmissionRejected

__all__ = ["ModelEntry", "ModelPool", "MultiModelServeEngine",
           "device_copy", "kv_page_bytes", "params_nbytes"]


def params_nbytes(params) -> int:
    """Device bytes a parameter store occupies, as the port holds it: an
    :class:`LM` (each tensor once, a tied head counted with the table)
    or a :class:`QuantizedParams` (dense leaves plus planes).  On float32
    configs this equals the reference's count of its tree; on bf16
    configs it is about half (the reference holds float32 weights)."""
    if isinstance(params, QuantizedParams):
        return params.nbytes()
    return sum(t.numel() * t.element_size() for t in params.parameters())


def kv_page_bytes(cfg: ModelConfig, page_size: int) -> int:
    """Device bytes one KV page of ``cfg`` holds (k + v, every layer and
    kv head; int8 caches carry their f32 per-(token, head) scales)."""
    if cfg.attn_free:
        return 0
    if cfg.kv_quant == "int8":
        per_row = cfg.hd * 1 + 4          # int8 values + f32 scale
    else:
        per_row = cfg.hd * cfg.compute_dtype.itemsize
    return 2 * cfg.n_layers * cfg.n_kv_heads * per_row * page_size


@dataclasses.dataclass
class ModelEntry:
    """One registered model: identity, bytes, and the host-side
    continuation state that survives unload/reload round trips."""

    model_id: str
    cfg: ModelConfig
    params: Any                   # the host master copy
    weight_bytes: int
    page_bytes: int
    spec: Any = None              # optional LLMSpec for fleet modeling
    loads: int = 0
    #: admission counter preserved across unload -> reload so the
    #: sampling lineage of a reloaded model continues bit for bit
    admit_count: int = 0
    #: engine stats accumulated across residencies
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)


class ModelPool:
    """Registry + HBM byte budget + host-link swap model for one board.

    Pure accounting: ``load``/``unload`` keep the resident set and the
    LRU clock; the caller decides WHEN to swap and carries the returned
    transfer seconds (modelled for ``profile``, default the CMP 170HX
    without FMA, as in the reference) into its own time model."""

    #: flat stats key -> metric name (the modelpool telemetry schema)
    STATS_SCHEMA = {
        "model_swaps": "modelpool.swaps",
        "swap_bytes": "modelpool.swap_bytes",
        "swap_seconds": "modelpool.swap_seconds",
        "unloads": "modelpool.unloads",
    }

    def __init__(self, hbm_bytes: float, page_size: int = 16,
                 profile: Optional[DeviceProfile] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.hbm_bytes = int(hbm_bytes)
        self.page_size = int(page_size)
        self.profile = profile or get_profile("cmp-170hx-nofma")
        self.entries: Dict[str, ModelEntry] = {}
        self._resident: Dict[str, int] = {}      # model_id -> last-used tick
        self._kv_charge: Dict[str, int] = {}     # model_id -> charged KV bytes
        self._tick = 0
        self.registry = registry if registry is not None else MetricsRegistry()
        for metric_name in self.STATS_SCHEMA.values():
            self.registry.counter(metric_name)
        self._stats = StatsView(self.registry, dict(self.STATS_SCHEMA))
        self.registry.gauge("modelpool.bytes.used", fn=self.used_bytes,
                            help="HBM bytes held by weights + KV charges")
        self.registry.gauge("modelpool.bytes.free", fn=self.free_bytes,
                            help="HBM bytes left in the board budget")
        self.registry.gauge("modelpool.residents",
                            fn=lambda: len(self._resident),
                            help="models currently resident")

    @property
    def stats(self) -> StatsView:
        """The flat stats mapping, backed by the metrics registry."""
        return self._stats

    @stats.setter
    def stats(self, values: Dict[str, Any]) -> None:
        for k, v in values.items():
            self._stats[k] = v

    # -- registry -------------------------------------------------------
    def register(self, model_id: str, cfg: ModelConfig, params,
                 spec=None) -> ModelEntry:
        invariant(model_id not in self.entries,
                  f"duplicate model {model_id}")
        entry = ModelEntry(model_id=model_id, cfg=cfg, params=params,
                           weight_bytes=params_nbytes(params),
                           page_bytes=kv_page_bytes(cfg, self.page_size),
                           spec=spec)
        invariant(entry.weight_bytes <= self.hbm_bytes, (
            f"{model_id} weights ({entry.weight_bytes}B) exceed the board "
            f"budget ({self.hbm_bytes}B)"),
            weight_bytes=entry.weight_bytes, hbm_bytes=self.hbm_bytes)
        self.entries[model_id] = entry
        return entry

    def __contains__(self, model_id: str) -> bool:
        return model_id in self.entries

    # -- residency ------------------------------------------------------
    def is_resident(self, model_id: str) -> bool:
        return model_id in self._resident

    def resident_lru(self) -> List[str]:
        """Resident model ids, least-recently-used first."""
        return sorted(self._resident, key=lambda m: (self._resident[m], m))

    def touch(self, model_id: str) -> None:
        self._tick += 1
        self._resident[model_id] = self._tick

    # -- budget ---------------------------------------------------------
    def weight_bytes_resident(self) -> int:
        return sum(self.entries[m].weight_bytes
                   for m in sorted(self._resident))

    def kv_bytes_resident(self) -> int:
        return sum(self._kv_charge[m] for m in sorted(self._kv_charge))

    def used_bytes(self) -> int:
        return self.weight_bytes_resident() + self.kv_bytes_resident()

    def free_bytes(self) -> int:
        return self.hbm_bytes - self.used_bytes()

    def charge_kv(self, model_id: str, nbytes: int) -> None:
        """Record the KV bytes ``model_id``'s page pool currently pins
        (active pages x page bytes; the engine calls this after every
        shrink/grow/build)."""
        invariant(self.is_resident(model_id),
                  f"kv charge for non-resident model {model_id}")
        self._kv_charge[model_id] = int(nbytes)

    # -- swaps ----------------------------------------------------------
    def load(self, model_id: str) -> float:
        """Mark ``model_id`` resident; returns the modelled seconds its
        weights spend crossing the host link."""
        entry = self.entries[model_id]
        if self.is_resident(model_id):
            self.touch(model_id)
            return 0.0
        invariant(entry.weight_bytes <= self.free_bytes(), (
            f"load({model_id}): {entry.weight_bytes}B of weights do not "
            f"fit in {self.free_bytes()}B free -- evict or shrink first"),
            weight_bytes=entry.weight_bytes, free_bytes=self.free_bytes())
        self.touch(model_id)
        self._kv_charge[model_id] = 0
        entry.loads += 1
        seconds = link_transfer_seconds(self.profile, entry.weight_bytes)
        self.stats["model_swaps"] += 1
        self.stats["swap_bytes"] += entry.weight_bytes
        self.stats["swap_seconds"] += seconds
        return seconds

    def unload(self, model_id: str) -> float:
        """Drop ``model_id`` from residency.  Weights are read-only (the
        master copy lives in host RAM), so nothing writes back: the cost
        of an unload is paid later, by the reload."""
        invariant(self.is_resident(model_id),
                  f"unload of non-resident model {model_id}")
        invariant(self._kv_charge.get(model_id, 0) == 0, (
            f"unload({model_id}) with live KV charge -- release pages "
            "first"), kv_charge=self._kv_charge.get(model_id, 0))
        del self._resident[model_id]
        del self._kv_charge[model_id]
        self.stats["unloads"] += 1
        return 0.0


def device_copy(cfg: ModelConfig, params: LM,
                 device: torch.device) -> LM:
    """The weights on ``device``: the host copy itself when it already
    lies there, else a fresh module tree with every tensor copied over
    (the bytes a swap moves)."""
    first = next(params.parameters())
    if first.device.type == device.type:
        return params
    out = LM(cfg, device)
    host = dict(params.named_parameters())
    with torch.no_grad():
        for name, t in out.named_parameters():
            t.copy_(host[name])
    return out


class MultiModelServeEngine:
    """Continuous batching over N models sharing one board's HBM.

    One inner paged :class:`ServeEngine` per resident model, all built
    with the same ``n_lanes``/``max_len``/``temperature``/``rng_seed``/
    ``dispatch_n``/``page_size``, so each model's streams match the
    single-model engine bit for bit.  Every inner engine's physical
    page array is allocated at the dense target (``n_lanes`` full
    contexts) and its PagePool immediately ``shrink``-ed to what the
    byte budget affords; later loads shrink it further (free pages
    only), unloads ``grow`` it back.

    Admission is head-of-line FIFO over the submitted request list
    (which preserves per-model FIFO, the exactness requirement): the
    head request's model is made resident -- shrinking, then LRU-
    evicting idle models -- before its admission is attempted.

    ``device`` is where the engines serve (``cuda`` unless ``"cpu"``).
    ``load_seconds`` lists ``(model_id, weight bytes, seconds)`` for
    each load's host-to-device copy, the device synchronised after it,
    on the tracer's clock; on the CPU no copy is made.
    """

    #: flat stats key -> metric name (the multi-model telemetry schema)
    STATS_SCHEMA = {
        "model_swaps": "mm.weights.swaps",
        "swap_bytes": "mm.weights.swap_bytes",
        "swap_seconds": "mm.weights.swap_seconds",
        "weight_evictions": "mm.weights.evictions",
        "kv_pages_shrunk": "mm.kv.pages_shrunk",
        "kv_pages_grown": "mm.kv.pages_grown",
    }

    def __init__(self, pool: ModelPool, n_lanes: int = 2,
                 max_len: int = 64, temperature: float = 0.0,
                 rng_seed: int = 0, dispatch_n: int = 8,
                 prefill_bucketing: bool = True,
                 prefix_sharing: bool = False, sanitize: bool = False,
                 tracer: Optional[SpanTracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 name: str = "mm", device=None):
        self.pool = pool
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.temperature = temperature
        self.rng_seed = rng_seed
        self.dispatch_n = dispatch_n
        self.prefill_bucketing = prefill_bucketing
        # per-model radix prompt caches: each inner engine gets its own
        # (prefixes never match across models), dropped whole when the
        # model's weights unload
        self.prefix_sharing = bool(prefix_sharing)
        # forwarded to every inner engine: each gets its own strict
        # PageSanitizer over its own PagePool
        self.sanitize = bool(sanitize)
        self.device = resolve_device(device)
        self.engines: Dict[str, ServeEngine] = {}
        # one registry for the whole board: the byte pool, this engine,
        # and every inner per-model ServeEngine (namespaced by model id)
        self.name = name
        self.registry = registry if registry is not None else pool.registry
        self.tracer = tracer if tracer is not None else SpanTracer(
            enabled=False, registry=self.registry)
        self.load_seconds: List[tuple] = []
        for metric_name in self.STATS_SCHEMA.values():
            self.registry.counter(metric_name)
        self._stats = StatsView(self.registry, dict(self.STATS_SCHEMA))

    @property
    def stats(self) -> StatsView:
        """The flat stats mapping, backed by the metrics registry."""
        return self._stats

    @stats.setter
    def stats(self, values: Dict[str, Any]) -> None:
        for k, v in values.items():
            self._stats[k] = v

    # -- geometry -------------------------------------------------------
    def _bt_width(self, cfg: ModelConfig) -> int:
        if cfg.attn_free:
            return 0
        return paged_capacity(self.max_len, cfg) // self.pool.page_size

    def _dense_pages(self, cfg: ModelConfig) -> int:
        return self.n_lanes * self._bt_width(cfg)

    def _charge(self, model_id: str) -> None:
        """Sync the pool's KV byte charge with the engine's ACTIVE pages
        (+1 for the scratch page, which is real HBM)."""
        eng = self.engines[model_id]
        entry = self.pool.entries[model_id]
        self.pool.charge_kv(model_id,
                            (eng.pool.n_active + 1) * entry.page_bytes)

    def physical_kv_bytes(self) -> Dict[str, int]:
        """Device bytes each resident engine's page array holds: the
        dense target plus the scratch page, disabled pages included
        (the budget charges only the active ones)."""
        return {mid: (eng.pool.n_pages + 1)
                * self.pool.entries[mid].page_bytes
                for mid, eng in sorted(self.engines.items())}

    # -- residency ------------------------------------------------------
    @property
    def resident_models(self) -> List[str]:
        return list(self.engines)

    def live_models(self) -> List[str]:
        return [m for m, e in self.engines.items() if e.live_lanes()]

    def _pinned(self, model_id: str) -> bool:
        """A model serving live lanes is never unloaded."""
        eng = self.engines[model_id]
        return bool(eng.live_lanes())

    def _unload(self, model_id: str) -> None:
        eng = self.engines.pop(model_id)
        invariant(not eng.live_lanes(),
                  f"unload of live model {model_id}",
                  live_lanes=eng.live_lanes())
        if eng.prefix_cache is not None:
            # cached pages index KV this model computed: a reload gets a
            # cold cache, and the refs drop NOW so the zero-KV-charge
            # check below (and the byte budget) sees no phantom pages
            eng.prefix_cache.flush()
            eng.pool.check()
            invariant(eng.pool.n_in_use == 0,
                      f"unload of {model_id} with pages still referenced",
                      n_in_use=eng.pool.n_in_use)
            # the registry's gauge must not keep the dropped engine (and
            # its device memory) alive; its flushed cache read 0
            self.registry.gauge(f"{model_id}.prefix.cached_pages",
                                fn=lambda: 0)
        entry = self.pool.entries[model_id]
        # preserve the sampling lineage and accumulate stats so a
        # reload continues exactly where this residency stopped
        entry.admit_count = eng._admit_count
        for k, v in eng.stats.items():
            entry.stats[k] = entry.stats.get(k, 0) + v
        self.pool.charge_kv(model_id, 0)
        self.pool.unload(model_id)
        self.stats["weight_evictions"] += 1
        # the device memory goes with the engine: its graphs first (a
        # graph destroyed later, by the collector during another
        # engine's capture, would invalidate that capture), then the
        # engine, its cache and its weights
        eng.graphs.release()
        del eng
        gc.collect()

    def _shrink_other(self, keep: str, need_bytes: int) -> None:
        """Retire free KV pages of other residents, LRU first, until
        ``need_bytes`` fit (or nothing shrinkable remains).  Every
        resident keeps a FLOOR of one full context (its ``bt_width``):
        below that a model could never admit another request."""
        for other in self.pool.resident_lru():
            if self.pool.free_bytes() >= need_bytes:
                return
            if other == keep or other not in self.engines:
                continue
            entry = self.pool.entries[other]
            if entry.page_bytes <= 0:
                continue
            lack = -(-(need_bytes - self.pool.free_bytes())
                     // entry.page_bytes)
            floor = self._bt_width(entry.cfg)
            oeng = self.engines[other]
            want = min(lack, max(oeng.pool.n_active - floor, 0))
            if oeng.prefix_cache is not None \
                    and oeng.pool.available() < want:
                # pages pinned by the victim's prefix cache are
                # reclaimable bytes: drop cache entries (LRU) until the
                # shrink can land
                oeng._trim_prefix_cache(want)
            shrunk = oeng.pool.shrink(want)
            if shrunk:
                self.stats["kv_pages_shrunk"] += shrunk
                self._charge(other)

    def _evict_idle(self, keep: str, need_bytes: int) -> None:
        """LRU-unload idle residents until ``need_bytes`` fit."""
        for other in self.pool.resident_lru():
            if self.pool.free_bytes() >= need_bytes:
                return
            if other == keep or other not in self.engines:
                continue
            if self._pinned(other):
                continue
            self._unload(other)

    def _rebalance(self) -> None:
        """Grow residents' page pools back toward the dense target,
        most-recently-used first, while the budget allows."""
        for mid in reversed(self.pool.resident_lru()):
            eng = self.engines.get(mid)
            entry = self.pool.entries[mid]
            if eng is None or entry.page_bytes <= 0:
                continue
            afford = self.pool.free_bytes() // entry.page_bytes
            grown = eng.pool.grow(min(eng.pool.n_disabled, max(afford, 0)))
            if grown:
                self.stats["kv_pages_grown"] += grown
                self._charge(mid)

    def _weights_on_device(self, entry: ModelEntry) -> LM:
        if not isinstance(entry.params, LM):
            raise TypeError(
                f"{entry.model_id}: the engine serves an LM; dequantize "
                f"a quantized store first (dequantize_params)")
        t0 = self.tracer.clock()
        params = device_copy(entry.cfg, entry.params, self.device)
        if params is not entry.params:
            torch.cuda.synchronize(self.device)
            self.load_seconds.append((entry.model_id, entry.weight_bytes,
                                      self.tracer.clock() - t0))
        return params

    def ensure_resident(self, model_id: str) -> Optional[ServeEngine]:
        """Make ``model_id`` resident (shrinking, then LRU-evicting idle
        models for budget) and return its engine; ``None`` when pinned
        residents hold too much HBM right now -- the caller retries
        after retirements, as page-blocked admission does."""
        if model_id not in self.pool.entries:
            raise KeyError(f"model {model_id!r} is not registered")
        if model_id in self.engines:
            self.pool.touch(model_id)
            return self.engines[model_id]
        entry = self.pool.entries[model_id]
        bt = self._bt_width(entry.cfg)
        # minimum viable residency: weights + one full context of pages
        # + the scratch page (an engine below this could never admit)
        need = entry.weight_bytes + (bt + 1) * entry.page_bytes
        if self.pool.free_bytes() < need:
            self._shrink_other(model_id, need)
        if self.pool.free_bytes() < need:
            self._evict_idle(model_id, need)
        if self.pool.free_bytes() < need:
            return None
        with self.tracer.span("weights.swap", track=self.name,
                              model_id=model_id,
                              weight_bytes=entry.weight_bytes):
            seconds = self.pool.load(model_id)
            # the pool's counters are the source of truth for swap
            # accounting; the engine's stats mirror them
            for k in ("model_swaps", "swap_bytes", "swap_seconds"):
                self.stats[k] = self.pool.stats[k]
            dense = self._dense_pages(entry.cfg)
            if entry.page_bytes > 0:
                # load() already moved the weights into the resident
                # charge: what is free now is all KV headroom (minus the
                # scratch page)
                afford = self.pool.free_bytes() // entry.page_bytes - 1
                target = max(min(dense, afford), bt)
            else:
                target = dense
            eng = ServeEngine(entry.cfg, self._weights_on_device(entry),
                              n_lanes=self.n_lanes, max_len=self.max_len,
                              temperature=self.temperature,
                              rng_seed=self.rng_seed,
                              dispatch_n=self.dispatch_n,
                              prefill_bucketing=self.prefill_bucketing,
                              paged=True, page_size=self.pool.page_size,
                              n_pages=dense if dense else None,
                              prefix_sharing=(
                                  self.prefix_sharing
                                  and prefix_sharing_supported(entry.cfg)),
                              sanitize=self.sanitize,
                              tracer=self.tracer, registry=self.registry,
                              name=model_id, device=self.device)
            # physical array at the dense target, pool shrunk to the
            # byte budget: later unloads can grow it back without
            # reallocating
            eng.pool.shrink(dense - target)
            # restore the sampling lineage of a previous residency so
            # the reloaded model's next admission continues the stream
            eng._admit_count = entry.admit_count
            self.engines[model_id] = eng
            self._charge(model_id)
        self.tracer.instant("weights.swap.done", track=self.name,
                            model_id=model_id, link_seconds=seconds)
        return eng

    def load(self, model_id: str) -> bool:
        """Explicit load (no admission); True when resident after."""
        return self.ensure_resident(model_id) is not None

    def unload(self, model_id: str) -> bool:
        """Explicit unload; refused (False) while the model serves live
        lanes.  Freed bytes grow the remaining residents' page pools."""
        if model_id not in self.engines:
            return False
        if self._pinned(model_id):
            return False
        self._unload(model_id)
        self._rebalance()
        return True

    # -- serving --------------------------------------------------------
    def admit(self, req: Request) -> bool:
        eng = self.ensure_resident(req.model_id)
        if eng is None:
            return False
        return bool(eng.free_lanes()) and eng.admit(req)

    def decode_n(self, n: Optional[int] = None
                 ) -> Dict[str, Dict[int, List[int]]]:
        """Advance every resident model's live lanes one dispatch."""
        out: Dict[str, Dict[int, List[int]]] = {}
        for mid, eng in self.engines.items():
            if eng.live_lanes():
                out[mid] = eng.decode_n(n)
        return out

    def run(self, requests: Sequence[Request],
            dispatch_n: Optional[int] = None) -> List[Request]:
        """Serve a multi-model workload to completion.

        Head-of-line FIFO admission (preserves per-model order, the
        exactness contract); raises instead of livelocking when the
        head request can never be admitted and nothing is in flight.
        """
        for r in requests:
            invariant(r.model_id in self.pool.entries, (
                f"request uid={r.uid} names unregistered model "
                f"{r.model_id!r}"), uid=r.uid, model_id=r.model_id)
        pending: Deque[Request] = deque(requests)
        while pending or self.live_models():
            while pending and self.admit(pending[0]):
                pending.popleft()
            if not self.live_models():
                head = pending[0]
                raise AdmissionRejected(
                    uid=head.uid, reason="never_admissible",
                    retry_after_s=None,
                    message=(
                        f"request uid={head.uid} (model "
                        f"{head.model_id!r}) can never be admitted: "
                        f"hbm={self.pool.hbm_bytes}B, "
                        f"resident={self.resident_models} and nothing "
                        "is in flight to retire"))
            self.decode_n(dispatch_n)
        return list(requests)

    # -- reporting ------------------------------------------------------
    def model_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-model engine stats, merged across residencies."""
        out: Dict[str, Dict[str, int]] = {}
        for mid, entry in self.pool.entries.items():
            merged = dict(entry.stats)
            eng = self.engines.get(mid)
            if eng is not None:
                for k, v in eng.stats.items():
                    merged[k] = merged.get(k, 0) + v
            out[mid] = merged
        return out

    def kv_pages_active(self) -> Dict[str, int]:
        """Active (non-disabled) KV pages per resident model -- the
        visible side of the weights-vs-pages trade-off."""
        return {mid: eng.pool.n_active
                for mid, eng in self.engines.items()}
