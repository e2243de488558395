"""Execution-backed mode: replay a trace on the *real* ServeEngine.

Port of the reference's ``fleet/execution.py`` (all but the two
functions that need its fleet simulator, ``simulated_token_accounting``
and ``validate_token_accounting``).  It replays a
:class:`~repro_torch.fleet.workload.FleetRequest` trace through the
port's :class:`~repro_torch.serving.engine.ServeEngine` and
:class:`~repro_torch.serving.modelpool.MultiModelServeEngine`, on the
card unless ``device="cpu"``, and checks token accounting, preemption
exactness, crash recovery and multi-model exactness.  Arrival times
are ignored by the engine -- it saturates its lanes in arrival order --
because the checks are about *accounting* (every prompt token
prefilled, every generation capped at ``gen_len``) and streams, not
wall-clock latency.  ``params`` (or each model's, for the multi-model
replays: their host master copies) must lie on the replay's device.
"""

from __future__ import annotations

import dataclasses
import gc
import os
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.fleet.faults import FaultPlan
from repro_torch.fleet.workload import FleetRequest
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import paged_capacity
from repro_torch.obs import events as obs_events
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SpanTracer
from repro_torch.serving.engine import LaneCheckpoint, Request, ServeEngine
from repro_torch.serving.modelpool import (ModelPool, MultiModelServeEngine,
                                           device_copy, kv_page_bytes,
                                           params_nbytes)


@dataclasses.dataclass(frozen=True)
class ExecutionResult:
    """Token accounting from a real engine replay of a trace.

    ``kv_pages_hwm`` / ``kv_admit_blocked`` surface the paged engine's
    page-pool pressure: peak pages promised+mapped, and requests that
    found a free lane but had to WAIT for pages (counted once per
    blocked episode, so the number is dispatch-granularity invariant).
    Zero for a fixed-lane replay.  These feed the sim-to-real
    calibration loop: the simulator's ``SimNode.kv_pages_hwm`` models
    the same peak.  (The simulator's ``kv_spill_events`` counts
    over-commit TRANSITIONS in ``SimNode._note_occupancy`` -- a
    different event; the telemetry schema keeps them distinct as
    ``serve.kv.admit_blocked`` vs ``fleet.node.*.kv_spill_events``.)
    """

    prompt_tokens: int
    gen_tokens: int
    gen_by_uid: Dict[int, int]
    decode_dispatches: int = 0
    decode_steps: int = 0
    kv_pages_hwm: int = 0
    kv_admit_blocked: int = 0
    #: mid-decode evictions / checkpoint re-admissions / KV pages that
    #: crossed an evict->restore cycle during the replay (all zero when
    #: the replay runs without preemption injection)
    preemptions: int = 0
    restores: int = 0
    pages_migrated: int = 0
    #: prefix-sharing counters (zero unless the replay ran with
    #: ``prefix_sharing=True``): prompts that opened on cached pages,
    #: and prefill pages those hits avoided allocating
    prefix_hits: int = 0
    prefix_pages_saved: int = 0


def _prompt_for(rng: np.random.Generator, r: FleetRequest,
                vocab: int) -> np.ndarray:
    """Deterministic prompt ids for one fleet request.

    A request without prefix structure draws its whole prompt from the
    caller's shared ``rng`` stream -- byte-identical to the pre-prefix
    replays, so every pinned token stream survives.  A request with a
    ``prefix_id`` OPENS with its family's shared tokens (their own rng,
    keyed by family id, so all members agree regardless of arrival
    order) and draws only the unique tail from the shared stream.
    """
    if r.prefix_id is None:
        return rng.integers(0, vocab, r.prompt_len, dtype=np.int32)
    head_len = min(r.prefix_len, r.prompt_len - 1)
    head = np.random.default_rng((7919, r.prefix_id)).integers(
        0, vocab, head_len, dtype=np.int32)
    tail = rng.integers(0, vocab, r.prompt_len - head_len, dtype=np.int32)
    return np.concatenate([head, tail])


def trace_requests(trace: Sequence[FleetRequest], vocab: int,
                   seed: int) -> list:
    """Engine :class:`Request` list for a fleet trace, in the arrival
    order every replay in this module admits them."""
    rng = np.random.default_rng(seed)
    return [Request(uid=r.uid, prompt=_prompt_for(rng, r, vocab),
                    max_new_tokens=r.gen_len)
            for r in sorted(trace, key=lambda r: (r.arrival_s, r.uid))]


def run_trace_on_engine(trace: Sequence[FleetRequest], cfg: ModelConfig,
                        params, n_lanes: int = 2, max_len: int = 64,
                        vocab_size: Optional[int] = None,
                        seed: int = 0,
                        dispatch_n: int = 8,
                        paged: bool = False, page_size: int = 16,
                        n_pages: Optional[int] = None,
                        temperature: float = 0.0,
                        preempt_every: Optional[int] = None,
                        prefix_sharing: bool = False,
                        tracer: Optional[SpanTracer] = None,
                        registry: Optional[MetricsRegistry] = None,
                        device=None) -> ExecutionResult:
    """Serve ``trace`` through the real continuous batcher.

    Prompt token ids are derived deterministically from the request uid,
    so the replay itself is seed-reproducible.  ``dispatch_n`` is the
    engine's multi-token decode granularity (tokens per host dispatch);
    the replayed token counts are dispatch-size invariant.  ``paged``
    replays through the page-pool cache (token counts are layout
    invariant; the page stats are what changes).

    ``preempt_every`` (paged only) injects evict-and-replay churn: at
    every k-th dispatch boundary the live lane with the LONGEST context
    is evicted into a :class:`~repro_torch.serving.engine.LaneCheckpoint` and
    held until the pool re-admits it -- the execution-backed analogue of
    a fleet migration, minus the wire.  Token counts (and the token
    streams themselves, see ``validate_preemption_exactness``) must be
    preemption invariant.
    """
    vocab = vocab_size or cfg.vocab_size
    reqs = trace_requests(trace, vocab, seed)
    engine = ServeEngine(cfg, params, n_lanes=n_lanes, max_len=max_len,
                         dispatch_n=dispatch_n, paged=paged,
                         page_size=page_size, n_pages=n_pages,
                         temperature=temperature,
                         prefix_sharing=prefix_sharing, tracer=tracer,
                         registry=registry, device=device)
    if preempt_every is None:
        engine.run(reqs)
    else:
        assert paged, "preemption replay needs the paged engine"
        _run_with_preemption(engine, reqs, preempt_every)
    if paged:
        if engine.prefix_cache is not None:
            engine.prefix_cache.flush()      # release the cache's refs
        engine.pool.check()
        assert engine.pool.n_in_use == 0, "replay leaked KV pages"
    gen_by_uid = {r.uid: len(r.generated) for r in reqs}
    return ExecutionResult(
        prompt_tokens=sum(len(r.prompt) for r in reqs),
        gen_tokens=sum(gen_by_uid.values()),
        gen_by_uid=gen_by_uid,
        decode_dispatches=engine.stats["decode_dispatches"],
        decode_steps=engine.stats["decode_steps"],
        kv_pages_hwm=engine.stats["kv_pages_hwm"],
        kv_admit_blocked=engine.stats["kv_admit_blocked"],
        preemptions=engine.stats["preemptions"],
        restores=engine.stats["restores"],
        pages_migrated=engine.stats["pages_migrated"],
        prefix_hits=engine.stats["prefix_hits"],
        prefix_pages_saved=engine.stats["prefix_pages_saved"])


def _run_with_preemption(engine: ServeEngine, reqs, every: int) -> None:
    """Continuous batching with periodic evict-and-replay.

    Held checkpoints have strict re-admission priority over fresh
    requests (an evicted request must not starve behind the queue it
    was serving ahead of).  An empty engine always fits one checkpoint
    -- restore needs at most a full context, the pool's guaranteed
    minimum -- so the loop cannot wedge.
    """
    pending = list(reqs)
    held: deque = deque()
    blocks = 0
    while pending or held or engine.live_lanes():
        while held and engine.restore(held[0]):
            held.popleft()
        if not held:
            while pending and engine.free_lanes():
                if not engine.admit(pending[0]):
                    break
                pending.pop(0)
        if not engine.live_lanes():
            # lint: ok R004 harness deadlock guard, not a serving path
            raise RuntimeError("preemption replay made no progress")
        engine.decode_n()
        blocks += 1
        if blocks % every == 0:
            live = engine.live_lanes()
            if live:
                lane = max(live, key=lambda i: (engine.lane_context(i), -i))
                held.append(engine.evict(lane))


def validate_preemption_exactness(trace: Sequence[FleetRequest],
                                  cfg: ModelConfig, params,
                                  preempt_every: int = 2,
                                  **kw) -> Dict[str, object]:
    """Replay ``trace`` with and without evict-and-replay churn and diff
    the TOKEN STREAMS (not just counts): a migrated request must resume
    bit-identically.  Returns the diff plus the preemption counters.
    With ``prefix_sharing=True`` both replays share cached prefixes, so
    the diff also pins evict/restore of prefix-hit lanes."""
    kw = dict(kw, paged=True)
    vocab = kw.pop("vocab_size", None) or cfg.vocab_size

    def streams(preempt):
        reqs = trace_requests(trace, vocab, kw.get("seed", 0))
        engine = ServeEngine(cfg, params,
                             n_lanes=kw.get("n_lanes", 2),
                             max_len=kw.get("max_len", 64),
                             dispatch_n=kw.get("dispatch_n", 8),
                             paged=True,
                             page_size=kw.get("page_size", 16),
                             n_pages=kw.get("n_pages"),
                             temperature=kw.get("temperature", 0.0),
                             prefix_sharing=kw.get("prefix_sharing",
                                                   False),
                             device=kw.get("device"))
        if preempt:
            _run_with_preemption(engine, reqs, preempt_every)
        else:
            engine.run(reqs)
        if engine.prefix_cache is not None:
            engine.prefix_cache.flush()
        engine.pool.check()
        return {r.uid: tuple(r.generated) for r in reqs}, engine.stats

    base, _ = streams(False)
    moved, stats = streams(True)
    mismatches = {uid: (base[uid], moved[uid]) for uid in base
                  if base[uid] != moved[uid]}
    verdict = {
        "resume_exact": not mismatches,
        "mismatches": mismatches,
        "preemptions": stats["preemptions"],
        "restores": stats["restores"],
        "pages_migrated": stats["pages_migrated"],
    }
    # auditable record: the replay keeps evidence the check ran
    obs_events.emit("validate.preemption_exactness",
                    resume_exact=verdict["resume_exact"],
                    n_requests=len(base),
                    n_mismatches=len(mismatches),
                    preemptions=verdict["preemptions"],
                    restores=verdict["restores"],
                    pages_migrated=verdict["pages_migrated"])
    return verdict


@dataclasses.dataclass(frozen=True)
class FaultReplayResult:
    """Accounting from a crash-and-recover replay on the REAL engine.

    ``checkpointed_uids`` resumed from a :class:`LaneCheckpoint` taken at
    the last checkpoint tick before the crash (tokens generated since the
    tick were rolled back and re-decoded); ``replayed_uids`` had no
    checkpoint yet and restarted from the prompt.  ``retry_attempts``
    counts both recovery admissions and transient dispatch retries, and
    lands in the surviving engine's ``engine.retry.attempts`` counter.
    """

    gen_by_uid: Dict[int, int]
    streams: Dict[int, Tuple[int, ...]]
    crashes: int
    checkpointed_uids: Tuple[int, ...]
    replayed_uids: Tuple[int, ...]
    retry_attempts: int
    transients: int
    checkpoints: int
    #: flight-recorder dumps written during the replay (one per crash
    #: when a ``flight_dir`` was given), in the order they were written
    flight_dumps: Tuple[str, ...] = ()


def run_trace_with_faults(trace: Sequence[FleetRequest],
                          cfg: ModelConfig, params,
                          plan: Optional[FaultPlan] = None,
                          crash_at_dispatch: Optional[int] = None,
                          checkpoint_every: Optional[int] = 4,
                          transient_dispatches: Sequence[int] = (),
                          n_lanes: int = 2, max_len: int = 64,
                          vocab_size: Optional[int] = None, seed: int = 0,
                          dispatch_n: int = 8, page_size: int = 16,
                          n_pages: Optional[int] = None,
                          temperature: float = 0.0,
                          prefix_sharing: bool = False,
                          tracer: Optional[SpanTracer] = None,
                          registry: Optional[MetricsRegistry] = None,
                          flight_dir: Optional[str] = None,
                          slo=None, device=None) -> FaultReplayResult:
    """Replay ``trace`` through the real paged engine while injecting a
    node crash (plus optional transient dispatch errors) and recovering.

    "Time" here is the decode dispatch index (a :class:`FaultPlan` with
    ``at_dispatch`` events drives it; or pass the knobs directly).  Every
    ``checkpoint_every`` dispatches each live lane is checkpointed -- an
    evict/restore round trip, so the snapshot is exactly what a fleet
    would hold host-side.  At ``crash_at_dispatch`` the engine ("node0")
    dies with its lanes; a fresh engine ("node1") takes over:
    checkpointed lanes re-enter from their snapshot (their request's
    stream rolled back to the tick), the rest replay from the prompt.
    Greedy streams must come out bit-identical to an undisturbed run
    (``validate_recovery_exactness`` pins this).

    Observability: pass ONE shared ``tracer``/``registry`` and both
    engines emit onto it, so ``repro_torch.obs.requests`` reconstructs
    gap-free per-request timelines ACROSS the migration hop
    (:func:`repro_torch.obs.request_timelines`).  With a
    ``flight_dir``, each engine gets a flight recorder tapped into the
    tracer and the dying engine's ring is dumped to
    ``<flight_dir>/flight_<node>.jsonl`` at the crash (paths land in
    ``FaultReplayResult.flight_dumps``).  An ``slo`` controller is
    threaded into the engines and stepped at every dispatch drain.  On
    the card "node1" is built on the same device as "node0", once
    node0's graphs are released.
    """
    if plan is not None:
        if crash_at_dispatch is None:
            crash_at_dispatch = plan.crash_dispatch()
        transient_dispatches = plan.transient_dispatches()
    vocab = vocab_size or cfg.vocab_size
    reqs = trace_requests(trace, vocab, seed)
    final_req: Dict[int, Request] = {r.uid: r for r in reqs}

    def mk_engine(node: str) -> ServeEngine:
        flight = (FlightRecorder(name=node)
                  if flight_dir is not None else None)
        return ServeEngine(cfg, params, n_lanes=n_lanes, max_len=max_len,
                           dispatch_n=dispatch_n, paged=True,
                           page_size=page_size, n_pages=n_pages,
                           temperature=temperature,
                           prefix_sharing=prefix_sharing, name=node,
                           tracer=tracer, registry=registry,
                           flight=flight, slo=slo, device=device)

    engine = mk_engine("node0")
    flight_dumps: list = []
    pending = list(reqs)
    held: deque = deque()                  # checkpoints awaiting restore
    #: uid -> (checkpoint, generated-length at the tick); the request
    #: object inside keeps accumulating, so the length pins the rollback
    snapshots: Dict[int, Tuple[LaneCheckpoint, int]] = {}
    dispatch = 0
    crashes = 0
    checkpoints = 0
    transients = 0
    retry_attempts = 0
    transient_set = set(transient_dispatches)
    checkpointed: list = []
    replayed: list = []

    while pending or held or engine.live_lanes():
        while held and engine.restore(held[0]):
            held.popleft()
        if not held:
            while pending and engine.free_lanes():
                if not engine.admit(pending[0]):
                    break
                pending.pop(0)
        if not engine.live_lanes():
            # lint: ok R004 harness deadlock guard, not a serving path
            raise RuntimeError("fault replay made no progress")
        if dispatch in transient_set:
            # transient dispatch error: the dispatch fails and is
            # re-issued -- one retry attempt, no token-stream effect
            retry_attempts += 1
            engine.stats["retry_attempts"] += 1
            transients += 1
        engine.decode_n()
        dispatch += 1
        if checkpoint_every and dispatch % checkpoint_every == 0:
            for lane in list(engine.live_lanes()):
                ckpt = engine.evict(lane)
                snapshots[ckpt.uid] = (ckpt, len(ckpt.req.generated))
                assert engine.restore(ckpt), \
                    "checkpoint round trip must fit the pages it freed"
            checkpoints += 1
        if crash_at_dispatch is not None and dispatch == crash_at_dispatch:
            # node0 dies fail-stop: its lanes (and their pages) are gone
            crashes += 1
            casualties = [engine.lane_req[i] for i in engine.live_lanes()]
            if engine.flight is not None:
                # black box first: dump the dying engine's ring at the
                # faulting op, before the survivor takes over
                flight_dumps.append(engine.flight.dump(
                    os.path.join(flight_dir,
                                 f"flight_{engine.name}.jsonl"),
                    reason=f"crash at dispatch {dispatch}",
                    registry=engine.registry, dispatch=dispatch))
            # the dead engine's graphs and memory go before the
            # survivor's first capture on the same device
            engine.graphs.release()
            engine = mk_engine("node1")
            gc.collect()
            for req in casualties:
                snap = snapshots.get(req.uid)
                if snap is not None:
                    ckpt, glen = snap
                    resumed = Request(uid=req.uid, prompt=req.prompt,
                                      max_new_tokens=req.max_new_tokens,
                                      generated=list(req.generated[:glen]),
                                      model_id=req.model_id,
                                      priority=req.priority)
                    final_req[req.uid] = resumed
                    held.append(dataclasses.replace(ckpt, req=resumed))
                    checkpointed.append(req.uid)
                else:
                    req.generated.clear()    # no checkpoint yet: from prompt
                    pending.insert(0, req)
                    replayed.append(req.uid)
                retry_attempts += 1
            # node0's counter died with it; the surviving engine carries
            # the replay-level total under engine.retry.attempts
            engine.stats["retry_attempts"] = retry_attempts

    if engine.prefix_cache is not None:
        engine.prefix_cache.flush()
    engine.pool.check()
    assert engine.pool.n_in_use == 0, "fault replay leaked KV pages"
    streams = {uid: tuple(r.generated) for uid, r in final_req.items()}
    return FaultReplayResult(
        gen_by_uid={uid: len(s) for uid, s in streams.items()},
        streams=streams, crashes=crashes,
        checkpointed_uids=tuple(checkpointed),
        replayed_uids=tuple(replayed),
        retry_attempts=engine.stats["retry_attempts"],
        transients=transients, checkpoints=checkpoints,
        flight_dumps=tuple(flight_dumps))


def validate_recovery_exactness(trace: Sequence[FleetRequest],
                                cfg: ModelConfig, params,
                                crash_at_dispatch: int = 6,
                                checkpoint_every: int = 3,
                                transient_dispatches: Sequence[int] = (2,),
                                flight_dir: Optional[str] = None,
                                **kw) -> Dict[str, object]:
    """The recovery oracle: crash a node mid-trace and diff the TOKEN
    STREAMS against an undisturbed run.

    Checkpointed lanes must resume BIT-IDENTICALLY (the sampling
    identity travels in the checkpoint); replayed-from-prompt lanes must
    also complete identically under greedy decoding (the stream is a
    pure function of the prompt).  Returns the verdict plus the recovery
    counters, and leaves an auditable ``repro_torch.obs`` event behind.
    ``flight_dir`` goes to the faulted replay only (the crashed node's
    flight dump lands there).
    """
    kw = dict(kw, temperature=0.0)      # the bit-exactness contract is greedy
    base = run_trace_on_engine(trace, cfg, params, paged=True,
                               **{k: v for k, v in kw.items()
                                  if k != "temperature"})
    # stream-level baseline: rebuild the same requests and run clean
    vocab = kw.get("vocab_size") or cfg.vocab_size
    clean = trace_requests(trace, vocab, kw.get("seed", 0))
    eng = ServeEngine(cfg, params, n_lanes=kw.get("n_lanes", 2),
                      max_len=kw.get("max_len", 64),
                      dispatch_n=kw.get("dispatch_n", 8), paged=True,
                      page_size=kw.get("page_size", 16),
                      n_pages=kw.get("n_pages"), temperature=0.0,
                      prefix_sharing=kw.get("prefix_sharing", False),
                      device=kw.get("device"))
    eng.run(clean)
    base_streams = {r.uid: tuple(r.generated) for r in clean}

    faulted = run_trace_with_faults(
        trace, cfg, params, crash_at_dispatch=crash_at_dispatch,
        checkpoint_every=checkpoint_every,
        transient_dispatches=transient_dispatches, flight_dir=flight_dir,
        **kw)
    ckpt_mismatch = {uid: (base_streams[uid], faulted.streams[uid])
                     for uid in faulted.checkpointed_uids
                     if base_streams[uid] != faulted.streams[uid]}
    replay_mismatch = {uid: (base_streams[uid], faulted.streams[uid])
                       for uid in faulted.replayed_uids
                       if base_streams[uid] != faulted.streams[uid]}
    verdict = {
        "resume_exact": not ckpt_mismatch,
        "replay_exact": not replay_mismatch,
        "counts_match": faulted.gen_by_uid == base.gen_by_uid,
        "crashes": faulted.crashes,
        "recovered_lanes": len(faulted.checkpointed_uids),
        "replayed_from_prompt": len(faulted.replayed_uids),
        "retry_attempts": faulted.retry_attempts,
        "checkpoints": faulted.checkpoints,
        "mismatches": {**ckpt_mismatch, **replay_mismatch},
    }
    obs_events.emit("validate.recovery_exactness",
                    resume_exact=verdict["resume_exact"],
                    replay_exact=verdict["replay_exact"],
                    counts_match=verdict["counts_match"],
                    crashes=verdict["crashes"],
                    recovered_lanes=verdict["recovered_lanes"],
                    replayed_from_prompt=verdict["replayed_from_prompt"],
                    retry_attempts=verdict["retry_attempts"])
    return verdict


@dataclasses.dataclass(frozen=True)
class MultiModelExecutionResult:
    """Token + swap accounting from a multi-model engine replay."""

    prompt_tokens: int
    gen_tokens: int
    gen_by_uid: Dict[int, int]
    gen_by_model: Dict[str, int]
    model_swaps: int = 0
    swap_bytes: int = 0
    weight_evictions: int = 0
    kv_pages_shrunk: int = 0
    kv_pages_grown: int = 0


def dense_hbm_bytes(models: Dict[str, Tuple[ModelConfig, object]],
                    n_lanes: int, max_len: int, page_size: int) -> int:
    """Board budget holding EVERY model resident at its dense KV target
    (weights + ``n_lanes`` full contexts + scratch) -- the no-swap
    baseline; anything tighter exercises weight paging."""
    total = 0
    for cfg, params in models.values():
        bt = (0 if cfg.attn_free
              else paged_capacity(max_len, cfg) // page_size)
        total += params_nbytes(params) + (
            n_lanes * bt + 1) * kv_page_bytes(cfg, page_size)
    return total


def _mm_requests(trace: Sequence[FleetRequest],
                 models: Dict[str, Tuple[ModelConfig, object]],
                 seed: int) -> list:
    """Deterministic multi-model request list from a fleet trace (ids
    derived from one rng stream, exactly like ``run_trace_on_engine``,
    clamped to each request's own model vocab)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r in sorted(trace, key=lambda r: (r.arrival_s, r.uid)):
        assert r.model_id in models, f"trace uid={r.uid} names " \
            f"unregistered model {r.model_id!r}"
        vocab = models[r.model_id][0].vocab_size
        reqs.append(Request(uid=r.uid,
                            prompt=_prompt_for(rng, r, vocab),
                            max_new_tokens=r.gen_len,
                            model_id=r.model_id))
    return reqs


def run_multimodel_trace_on_engine(
        trace: Sequence[FleetRequest],
        models: Dict[str, Tuple[ModelConfig, object]],
        hbm_bytes: Optional[int] = None,
        n_lanes: int = 2, max_len: int = 64, seed: int = 0,
        dispatch_n: int = 8, page_size: int = 16,
        temperature: float = 0.0,
        prefix_sharing: bool = False, device=None,
        tracer: Optional[SpanTracer] = None) -> MultiModelExecutionResult:
    """Serve a multi-model ``trace`` through the REAL
    :class:`~repro_torch.serving.modelpool.MultiModelServeEngine`.

    ``models`` maps model id -> (cfg, params).  ``hbm_bytes`` is the
    board budget weights and KV pages share; ``None`` sizes it to hold
    every model at its dense KV target (no swap pressure), which is the
    accounting baseline -- pass something tighter to exercise weight
    paging.  Token counts must be budget invariant (streams depend only
    on per-model admission order); the swap counters are what changes.
    ``models``' params are the host master copies the pool registers;
    each load copies them to ``device``.
    """
    if hbm_bytes is None:
        hbm_bytes = dense_hbm_bytes(models, n_lanes=n_lanes,
                                    max_len=max_len, page_size=page_size)
    pool = ModelPool(hbm_bytes, page_size=page_size)
    for mid in sorted(models):
        pool.register(mid, models[mid][0], models[mid][1])
    engine = MultiModelServeEngine(pool, n_lanes=n_lanes, max_len=max_len,
                                   temperature=temperature, rng_seed=seed,
                                   dispatch_n=dispatch_n,
                                   prefix_sharing=prefix_sharing,
                                   device=device, tracer=tracer)
    reqs = _mm_requests(trace, models, seed)
    engine.run(reqs)
    for eng in engine.engines.values():
        if eng.prefix_cache is not None:
            eng.prefix_cache.flush()
        eng.pool.check()
        assert eng.pool.n_in_use == 0, "replay leaked KV pages"
    gen_by_uid = {r.uid: len(r.generated) for r in reqs}
    gen_by_model: Dict[str, int] = {}
    for r in reqs:
        gen_by_model[r.model_id] = (gen_by_model.get(r.model_id, 0)
                                    + len(r.generated))
    return MultiModelExecutionResult(
        prompt_tokens=sum(len(r.prompt) for r in reqs),
        gen_tokens=sum(gen_by_uid.values()),
        gen_by_uid=gen_by_uid, gen_by_model=gen_by_model,
        model_swaps=engine.stats["model_swaps"],
        swap_bytes=engine.stats["swap_bytes"],
        weight_evictions=engine.stats["weight_evictions"],
        kv_pages_shrunk=engine.stats["kv_pages_shrunk"],
        kv_pages_grown=engine.stats["kv_pages_grown"])


def validate_multimodel_exactness(
        trace: Sequence[FleetRequest],
        models: Dict[str, Tuple[ModelConfig, object]],
        hbm_bytes: Optional[int] = None, **kw) -> Dict[str, object]:
    """Replay a multi-model trace and diff each model's TOKEN STREAMS
    against the same requests served ALONE by a single-model
    ``ServeEngine`` with the same config/seed/temperature -- the
    exactness contract of the multi-model engine.  Returns the diff
    plus the swap counters.  ``device`` (in ``kw``) is where both run;
    each model's params are its host master copy, which the multi-model
    engine's loads and each solo engine copy to the device."""
    seed = kw.get("seed", 0)
    device = kw.get("device")
    engine_kw = dict(n_lanes=kw.get("n_lanes", 2),
                     max_len=kw.get("max_len", 64),
                     dispatch_n=kw.get("dispatch_n", 8),
                     temperature=kw.get("temperature", 0.0))
    page_size = kw.get("page_size", 16)

    reqs = _mm_requests(trace, models, seed)
    if hbm_bytes is None:
        hbm_bytes = dense_hbm_bytes(models, n_lanes=engine_kw["n_lanes"],
                                    max_len=engine_kw["max_len"],
                                    page_size=page_size)
    pool = ModelPool(hbm_bytes, page_size=page_size)
    for mid in sorted(models):
        pool.register(mid, models[mid][0], models[mid][1])
    mm = MultiModelServeEngine(pool, rng_seed=seed, device=device,
                               **engine_kw)
    mm.run(reqs)
    moved = {r.uid: tuple(r.generated) for r in reqs}
    stats = dict(mm.stats)
    for mid in sorted(mm.engines):      # the solo engines load alone
        mm.unload(mid)
    del mm

    mismatches = {}
    for mid in sorted(models):
        cfg, params = models[mid]
        solo = [Request(uid=r.uid, prompt=r.prompt.copy(),
                        max_new_tokens=r.max_new_tokens)
                for r in reqs if r.model_id == mid]
        ref = ServeEngine(cfg, device_copy(cfg, params, resolve_device(
                              device)), paged=True, page_size=page_size,
                          rng_seed=seed, device=device, **engine_kw)
        ref.run(solo)
        ref.graphs.release()
        del ref
        for r in solo:
            if tuple(r.generated) != moved[r.uid]:
                mismatches[r.uid] = (tuple(r.generated), moved[r.uid])
    verdict = {
        "exact": not mismatches,
        "mismatches": mismatches,
        "model_swaps": stats["model_swaps"],
        "swap_bytes": stats["swap_bytes"],
        "weight_evictions": stats["weight_evictions"],
        "gen_by_model": {mid: sum(len(r.generated) for r in reqs
                                  if r.model_id == mid)
                         for mid in sorted(models)},
    }
    # auditable record: the replay keeps evidence the check ran
    obs_events.emit("validate.multimodel_exactness",
                    exact=verdict["exact"],
                    n_requests=len(reqs),
                    n_mismatches=len(mismatches),
                    model_swaps=verdict["model_swaps"],
                    weight_evictions=verdict["weight_evictions"])
    return verdict
