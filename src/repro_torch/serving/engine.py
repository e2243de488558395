"""Serving engine: continuous batching over a fixed-lane or paged KV
cache.

Port of the reference's ``serving/engine.py``, both cache layouts:

* **fixed-lane** (default, the reference's parity oracle): the cache is
  ``n_lanes x max_len`` from construction; admission needs a free lane;
* **paged** (``paged=True``): KV lives in a global page pool governed by
  :class:`PagePool`; each lane holds a block table of page ids.
  Admission is gated on free PAGES (reserved for the request's worst
  case), pages are mapped at admission and at dispatch boundaries and
  freed at retirement; a dead lane's block-table row points at a
  scratch page the allocator never hands out.

On both:

* ``prefill`` pads prompts to power-of-two buckets, keeps the tail of
  prompts longer than ``max_len - 1`` and scatters the prompt KV into
  the lane's row or pages.  On the card each bucket's prefill is one
  CUDA graph, keyed ``("prefill", bucket)``: the first prompt of a
  bucket runs eagerly and is captured, later ones replay it over the
  bucket's token and last-position buffers, as the reference reruns
  its prefill jitted once per bucket (``prefill_compiles``).  The
  scatter, the int8 quantize and the first token's sampling stay
  outside the graph;
* ``decode_n`` advances every lane ``dispatch_n`` tokens per dispatch
  with no host sync inside; one host transfer drains the block.  On
  the card a dispatch is one CUDA graph per ``n_steps``
  (:mod:`repro_torch.serving.cuda_graphs`): the first dispatch of a
  size runs eagerly and is then captured, later ones replay it, and
  ``stats["decode_compiles"]`` counts the captures, as the reference
  counts its jit compiles of the decode scan.  The dispatch reads and
  writes only tensors that keep their address for the engine's life
  (the cache, next tokens, budgets, token indices); the host's writes
  between dispatches (admission, release, block-table rows) are in
  place.  On the CPU the same function runs eagerly every time;
* greedy or temperature sampling on the device, keyed as the reference
  keys it (threefry, :mod:`repro_torch.rng`): the first token by
  ``fold_in(rng_prefill, admission index)``, later ones by
  ``fold_in(fold_in(rng_decode, lane_seed), tok_idx)``, so a stream
  does not depend on dispatch size, neighbours or layout.

With ``cfg.kv_quant == "int8"`` both layouts hold int8 K/V with f32
per-(token, head) scales: the prompt KV is quantized on its way into
the cache, each decode step quantizes its new row, and the decode
kernels dequantize in their reads.  The first token still comes from
the full-precision prefill logits, as in the reference.

An attention-free (ssm) model keeps O(1) recurrent state per lane
(``ssm_h``/``ssm_conv``) on both layouts; paged, it holds no pages (a
pool of 0, admission needing 0).  A hybrid model holds that state
beside its sliding-window KV (a ring of ``window`` slots, or the
window's fixed page set).  As in the reference, the prefill of either
runs the chunked scan (K10 on the card; a hybrid's K2 too, whose KV is
scattered into the lane) and discards the logits; the lane's state is
zeroed and rebuilt by streaming the prompt through the decode step from
length 0, which rewrites every KV slot it reads, and the first token
comes from the streamed logits.  The stream steps a batch-1 cache of
its own at fixed addresses (state, length, and a hybrid's dense K/V
row or block-table row; the page pools pass through whole) and copies
it into the lane at the end; on the card each step after the engine's
first is a replay of one captured decode step.

A paged engine of the dense family without a window may share prompt
prefixes (``prefix_sharing=True``): a radix cache of prompt pages
(:mod:`repro_torch.serving.prefix_cache`) over a refcounted
:class:`PagePool`, matched pages mapped by refcount, a shared partial
page copied on write in place, and only the unmatched tail streamed
through the batch-1 decode step (int8 KV: full pages, and the batched
prefill replays).  Every paged engine can ``evict`` a live lane to a
host :class:`LaneCheckpoint` and ``restore`` it, here or on another
engine, in either framework.

The engine carries the reference's observability and resilience stack
(metrics registry, span tracer, flight recorder, SLO controller,
degradation ladder, page sanitizer; :class:`ServeEngine` says what each
measures on the card).  The pool's ``shrink``/``grow`` trade KV pages
for weight residency (:mod:`repro_torch.serving.modelpool`).

Weights can be stored block-quantized (:func:`quantize_params`) and
served dequantized and dense (:func:`dequantize_params`), as the
reference serves them.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng as trng
from repro_torch.analysis.invariants import invariant
from repro_torch.analysis.sanitizer import PageSanitizer
from repro_torch.device import resolve_device
from repro_torch.models.attention import quantize_kv_token
from repro_torch.models.common import ModelConfig, frozen
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import (LM, paged_capacity,
                                            sample_tokens)
from repro_torch.obs.flight import FlightRecorder, flight_guard
from repro_torch.obs.metrics import MetricsRegistry, StatsView
from repro_torch.obs.trace import SpanTracer
from repro_torch.quant.formats import get_format
from repro_torch.quant.quantize import QTensor, dequantize, quantize
from repro_torch.serving.cuda_graphs import StepGraphs
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.resilience import AdmissionRejected, DegradationLadder

__all__ = ["LaneCheckpoint", "PagePool", "PrefixHit", "QuantizedParams",
           "Request", "ServeEngine", "STATS_KEYS", "dequantize_params",
           "prefix_sharing_supported", "quantize_params", "reference_leaves"]


# ----------------------------------------------------------------------
# weight quantization store
# ----------------------------------------------------------------------

def reference_leaves(params: LM) -> List[Tuple[str, List[torch.nn.Parameter],
                                               Tuple[int, ...]]]:
    """The leaves of the reference's parameter tree, each as ``(path,
    the port's tensors that hold it, the reference leaf's shape)``.

    The reference stacks every block leaf along a leading layer axis,
    so ``blocks.attn.wq`` is ONE leaf of shape ``(L, d, q)`` held here
    by the ``L`` per-layer tensors; ``embed`` and ``final_norm`` leaves
    are one tensor each, of the same shape on both sides."""
    out = []
    for name, t in params.embed.named_parameters():
        out.append((f"embed.{name}", [t], tuple(t.shape)))
    n_layers = len(params.blocks)
    per_layer = [dict(b.named_parameters()) for b in params.blocks]
    for name, t in params.blocks[0].named_parameters():
        out.append((f"blocks.{name}", [layer[name] for layer in per_layer],
                    (n_layers,) + tuple(t.shape)))
    for name, t in params.final_norm.named_parameters():
        out.append((f"final_norm.{name}", [t], tuple(t.shape)))
    return out


def _slot(params: LM, path: str, layer: int) -> Tuple[torch.nn.Module, str]:
    """(module, attribute) holding layer ``layer`` of a reference leaf."""
    parts = path.split(".")
    mod = params.blocks[layer] if parts[0] == "blocks" else getattr(
        params, parts[0])
    for part in parts[1:-1]:
        mod = getattr(mod, part)
    return mod, parts[-1]


def _share(params: LM) -> LM:
    """A new module tree over the SAME tensors (no copy)."""
    memo = {id(t): t for t in params.parameters()}
    return copy.deepcopy(params, memo)


@dataclasses.dataclass
class QuantizedParams:
    """A quantized parameter store: ``quantized`` maps each quantized
    reference leaf (by path, e.g. ``"embed.tok"``) to its planes, and
    ``dense`` is the model's module tree over the weights kept dense (a
    quantized leaf's own slots hold only a shape, on the ``meta``
    device).  ``dtypes`` keeps each quantized leaf's compute dtype."""

    dense: LM
    quantized: Dict[str, QTensor]
    dtypes: Dict[str, torch.dtype]

    def nbytes(self) -> int:
        """Bytes held: the dense leaves plus every quantized leaf's
        planes."""
        return sum(t.numel() * t.element_size()
                   for t in self.dense.parameters()
                   if t.device.type != "meta") + sum(
            qt.nbytes() for qt in self.quantized.values())


def quantize_params(params: LM, fmt: str, min_size: int = 1 << 16):
    """Quantize every leaf the reference's ``quantize_params`` quantizes.

    Returns ``(QuantizedParams, stats)``.  The rule runs on the
    REFERENCE's tree (:func:`reference_leaves`): a leaf is quantized
    when it is 2-D, has at least ``min_size`` elements and its first
    axis divides the format's block.  The reference stacks its block
    weights ``(L, k, n)``, so they are 3-D and stay dense, though the
    port holds them per layer as 2-D matrices; today that leaves
    ``embed.tok`` (and ``embed.head`` when untied), and a stacked 1-D
    leaf (a norm scale, a bias) of a deep enough model, whose ``(L, n)``
    stack is quantized along the layer axis as the reference does.
    Small and odd-shaped weights stay dense, as llama.cpp keeps them.

    ``stats`` counts leaves as the reference does (one per stacked
    leaf); its byte counts are the bytes the port holds: equal to the
    reference's on float32 configs, and about half on bf16 configs,
    whose weights the port keeps in bf16 where the reference keeps a
    float32 tree.  The planes are :func:`repro_torch.quant.quantize`'s,
    bitwise the reference's for the same values, on either device."""
    blk = get_format(fmt).block
    n_q = n_dense = bytes_q = bytes_dense = 0
    shell = _share(params)
    quantized: Dict[str, QTensor] = {}
    dtypes: Dict[str, torch.dtype] = {}
    for path, tensors, shape in reference_leaves(params):
        size = int(np.prod(shape))
        if len(shape) == 2 and size >= min_size and shape[0] % blk == 0:
            w = tensors[0] if len(tensors) == 1 else torch.stack(
                [t.reshape(-1) for t in tensors])
            qt = quantize(w, fmt)
            quantized[path] = qt
            dtypes[path] = tensors[0].dtype
            n_q += 1
            bytes_q += qt.nbytes()
            for layer, t in enumerate(tensors):
                mod, attr = _slot(shell, path, layer)
                setattr(mod, attr, frozen(torch.empty(
                    t.shape, dtype=t.dtype, device="meta")))
            continue
        n_dense += 1
        bytes_dense += sum(t.numel() * t.element_size() for t in tensors)
    stats = {"quantized": n_q, "dense": n_dense,
             "quantized_bytes": bytes_q, "dense_bytes": bytes_dense}
    return QuantizedParams(shell, quantized, dtypes), stats


def dequantize_params(q_params: QuantizedParams) -> LM:
    """Materialize dense weights (carrying the quantization error): an
    :class:`LM` over the dense leaves, each quantized leaf dequantized
    (float32, as the reference's) and cast to its compute dtype -- the
    value the reference's cast at each use gives.  A tied head reads the
    dequantized ``embed.tok``."""
    out = _share(q_params.dense)
    for path, qt in sorted(q_params.quantized.items()):
        dense = dequantize(qt).to(q_params.dtypes[path])
        if not path.startswith("blocks."):
            mod, attr = _slot(out, path, 0)
            setattr(mod, attr, frozen(dense))
            continue
        for layer, row in enumerate(dense):    # an (L, n) stack
            mod, attr = _slot(out, path, layer)
            setattr(mod, attr, frozen(row.clone()))
    return out


# ----------------------------------------------------------------------
# page-pool allocator
# ----------------------------------------------------------------------

class PagePool:
    """Host-side free-list allocator over the global KV page pool, with
    a refcount per page (the reference's ``PagePool``).

    Invariants: ``n_free + n_in_use + n_disabled == n_pages``; pages move
    between disjoint sets (no double alloc, no double free); every
    in-use page has a refcount >= 1, one per holder (each lane mapping
    it, and the prefix cache when it caches it): ``share`` adds a
    holder, ``free`` drops one, and a page returns to the free list only
    when its LAST holder lets go; ``reserve(n)`` promises ``n`` future
    ``alloc`` (or ``cow``) pages and ``available()`` (what admission
    gates on) never counts promised pages, so mid-generation growth and
    a copy-on-write split cannot fail; ``shrink(n)`` retires up to ``n``
    FREE and unpromised pages into a disabled set and ``grow(n)``
    returns them, so the multi-model pool trades KV pages for weight
    residency without touching a page a lane holds or was promised
    (a shared page is in use like any other).  The free list is LIFO, as
    in the reference, so both hand out the same page ids for the same
    call sequence.  ``holder`` arguments are opaque owner tags, forwarded to
    the lifecycle ``monitor`` (a :class:`~repro_torch.analysis.sanitizer.
    PageSanitizer`) when one is attached: every mutator pays one
    attribute check for it, the whole cost of running unsanitized.
    """

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._in_use: set = set()
        self._refcount: Dict[int, int] = {}
        self._disabled: List[int] = []
        self._reserved = 0
        self.hwm = 0                 # high-water mark: in-use + reserved
        self.alloc_count = 0
        self.free_count = 0
        self.share_count = 0
        self.cow_count = 0
        self.monitor = None

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return len(self._in_use)

    @property
    def n_disabled(self) -> int:
        return len(self._disabled)

    @property
    def n_active(self) -> int:
        """Pages currently part of the pool (physical minus disabled)."""
        return self.n_pages - len(self._disabled)

    def available(self) -> int:
        """Pages admissible to NEW requests (free minus promised)."""
        return len(self._free) - self._reserved

    def reserve(self, n: int) -> bool:
        """Promise ``n`` pages to a request; False if over-committed."""
        ok = n <= self.available()
        if ok:
            self._reserved += n
            self.hwm = max(self.hwm, self.n_in_use + self._reserved)
        m = self.monitor
        if m is not None:
            m.record("reserve", n=n, ok=ok)
        return ok

    def unreserve(self, n: int) -> None:
        invariant(0 <= n <= self._reserved,
                  "unreserve exceeds reservation",
                  n=n, reserved=self._reserved)
        self._reserved -= n
        m = self.monitor
        if m is not None:
            m.record("unreserve", n=n)

    def alloc(self, n: int, holder: Any = None) -> List[int]:
        """Take ``n`` previously reserved pages off the free list, each
        with one holder."""
        invariant(n <= self._reserved, "alloc without reservation",
                  n=n, reserved=self._reserved)
        invariant(n <= len(self._free), "free list underflow",
                  n=n, n_free=len(self._free))
        self._reserved -= n
        pages = [self._free.pop() for _ in range(n)]
        self._in_use.update(pages)
        for p in pages:
            self._refcount[p] = 1
        self.alloc_count += n
        m = self.monitor
        if m is not None:
            m.record("alloc", pages=list(pages), holder=holder)
        return pages

    def free(self, pages: List[int], holder: Any = None) -> None:
        """Drop one reference per page; a page returns to the free list
        only when its last holder releases it (``free_count`` counts
        those returns, not reference drops)."""
        for p in pages:
            invariant(p in self._in_use, f"double free of page {p}",
                      page=p)
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                del self._refcount[p]
                self._in_use.remove(p)
                self._free.append(p)
                self.free_count += 1
        m = self.monitor
        if m is not None and pages:
            m.record("free", pages=list(pages), holder=holder)

    def share(self, pages: List[int], holder: Any = None) -> None:
        """Add one reference per page: another holder (a lane's block
        table, or the prefix cache) now maps the same bytes."""
        for p in pages:
            invariant(p in self._in_use,
                      f"share of unallocated page {p}", page=p)
            self._refcount[p] += 1
        self.share_count += len(pages)
        m = self.monitor
        if m is not None and pages:
            m.record("share", pages=list(pages), holder=holder)

    def cow(self, page: int, holder: Any = None) -> int:
        """Copy-on-write split: the caller gives up its reference on a
        SHARED ``page`` and receives a fresh exclusive page drawn from
        its reservation.  The caller copies the contents and rewrites its
        block-table entry; the other holders keep the original."""
        invariant(page in self._in_use,
                  f"cow of unallocated page {page}", page=page)
        invariant(self._refcount[page] >= 2,
                  "cow of an exclusively owned page", page=page,
                  refcount=self._refcount[page])
        invariant(self._reserved >= 1, "cow without a reservation",
                  page=page)
        self._reserved -= 1
        new = self._free.pop()
        self._in_use.add(new)
        self._refcount[new] = 1
        self._refcount[page] -= 1
        self.alloc_count += 1
        self.cow_count += 1
        m = self.monitor
        if m is not None:
            m.record("cow", old=page, new=new, holder=holder)
        return new

    def refcount(self, page: int) -> int:
        """Holders of ``page`` (0 if free)."""
        return self._refcount.get(page, 0)

    def is_shared(self, page: int) -> bool:
        return self._refcount.get(page, 0) >= 2

    @property
    def n_shared(self) -> int:
        """In-use pages with more than one holder."""
        return sum(1 for c in self._refcount.values() if c >= 2)

    @property
    def n_refs(self) -> int:
        """Total references across all in-use pages."""
        return sum(self._refcount.values())

    def shrink(self, n: int) -> int:
        """Retire up to ``n`` free, unpromised pages from the pool (HBM
        bytes leave the KV pool for weights).  Returns the number
        retired -- never a page a lane holds or a reservation promised."""
        take = max(min(int(n), self.available()), 0)
        pages = [self._free.pop() for _ in range(take)]
        self._disabled.extend(pages)
        m = self.monitor
        if m is not None and pages:
            m.record("shrink", pages=pages)
        return take

    def grow(self, n: int) -> int:
        """Return up to ``n`` retired pages to the free list (weights left
        the board; the KV pool gets its bytes back)."""
        back = max(min(int(n), len(self._disabled)), 0)
        pages = [self._disabled.pop() for _ in range(back)]
        self._free.extend(pages)
        m = self.monitor
        if m is not None and pages:
            m.record("grow", pages=pages)
        return back

    def bind_registry(self, registry: MetricsRegistry,
                      prefix: str = "pool") -> None:
        """Publish the pool's occupancy as live callback gauges (they
        read the allocator's own state, so the hot path pays nothing)."""
        registry.gauge(f"{prefix}.pages.free", fn=lambda: self.n_free,
                       help="free pages (incl. reserved)")
        registry.gauge(f"{prefix}.pages.in_use", fn=lambda: self.n_in_use,
                       help="pages allocated to live lanes")
        registry.gauge(f"{prefix}.pages.reserved",
                       fn=lambda: self._reserved,
                       help="pages promised to admitted requests")
        registry.gauge(f"{prefix}.pages.disabled",
                       fn=lambda: self.n_disabled,
                       help="pages retired for weight residency")
        registry.gauge(f"{prefix}.pages.hwm", fn=lambda: self.hwm,
                       help="high-water mark of in-use + reserved pages")
        registry.gauge(f"{prefix}.pages.allocs",
                       fn=lambda: self.alloc_count,
                       help="cumulative page allocations")
        registry.gauge(f"{prefix}.pages.frees",
                       fn=lambda: self.free_count,
                       help="cumulative page frees")
        registry.gauge(f"{prefix}.pages.shared",
                       fn=lambda: self.n_shared,
                       help="in-use pages with more than one holder")
        registry.gauge(f"{prefix}.pages.cow_splits",
                       fn=lambda: self.cow_count,
                       help="cumulative copy-on-write page splits")

    def check(self) -> None:
        """Raise unless the conservation invariants hold (test hook)."""
        invariant(len(self._free) + len(self._in_use)
                  + len(self._disabled) == self.n_pages,
                  "page conservation broken", n_free=len(self._free),
                  n_in_use=len(self._in_use),
                  n_disabled=len(self._disabled), n_pages=self.n_pages)
        invariant(len(set(self._free)) == len(self._free),
                  "duplicate page on the free list")
        invariant(len(set(self._disabled)) == len(self._disabled),
                  "duplicate page on the disabled list")
        invariant(not self._in_use.intersection(self._free),
                  "page both in use and free")
        invariant(not self._in_use.intersection(self._disabled),
                  "page both in use and disabled")
        invariant(not set(self._free).intersection(self._disabled),
                  "page both free and disabled")
        invariant(0 <= self._reserved <= len(self._free),
                  "reservation exceeds the free list",
                  reserved=self._reserved, n_free=len(self._free))
        invariant(set(self._refcount) == self._in_use,
                  "refcounts out of sync with the in-use set")
        invariant(all(c >= 1 for c in self._refcount.values()),
                  "in-use page with zero refcount")


# ----------------------------------------------------------------------
# continuous-batching engine
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (len,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: which registered model serves this request (the multi-model
    #: engine; a single-model ServeEngine ignores it)
    model_id: Optional[str] = None
    #: degradation-ladder victim order: LOWER priority is evicted first
    #: when the engine sheds load (ties: the longest live context)
    priority: int = 0


#: numpy has no bfloat16: a checkpoint carries a bf16 pool's values as
#: float32 (exact both ways); int8 values and f32 scales and state as
#: they are
_WIRE_DTYPE = {torch.bfloat16: np.float32, torch.float32: np.float32,
               torch.int8: np.int8}


@dataclasses.dataclass
class LaneCheckpoint:
    """Host-side snapshot of one live lane at a dispatch boundary: all a
    request needs to resume bit for bit, on this engine or another built
    with the same config, ``n_lanes``, ``rng_seed`` and ``temperature``
    (the reference's ``LaneCheckpoint``, field for field).

    ``lane_seed`` / ``tok_idx`` are the sampling identity, ``next_token``
    the token already sampled for the next step, ``remaining`` /
    ``ctx_len`` the budget left and the live length; ``kv_pages`` maps
    each pool key to the lane's pages gathered through its block table,
    in logical order, ``(L, n_pages, Hkv, ps, D)`` (scales ``(..., 1)``);
    ``ssm_state`` holds ``ssm_h`` / ``ssm_conv`` of an ssm or hybrid lane.
    The payload is numpy in the reference's layout, so a checkpoint
    crosses engines and frameworks; a bf16 pool's values travel as
    float32 (numpy has no bfloat16; the values are unchanged)."""

    req: Any
    lane_seed: int
    tok_idx: int
    remaining: int
    ctx_len: int
    next_token: int
    page_size: int
    kv_pages: Dict[str, np.ndarray]
    ssm_state: Dict[str, np.ndarray]

    @property
    def uid(self) -> int:
        return self.req.uid

    @property
    def n_pages(self) -> int:
        for v in self.kv_pages.values():
            return int(v.shape[1])
        return 0

    def nbytes(self) -> int:
        """Bytes a migration moves (KV + state), as carried here."""
        return sum(int(v.nbytes) for v in self.kv_pages.values()) + sum(
            int(v.nbytes) for v in self.ssm_state.values())


def prefix_sharing_supported(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` can serve with ``prefix_sharing=True``: the whole
    prompt context must be page-resident and append-only, so no sliding
    window (its lanes rewrite their page set in place) and no recurrent
    state (a mapped prefix would skip rebuilding it): the dense, moe and
    vlm families without a window."""
    return (not cfg.is_encdec and not cfg.attn_free and not cfg.has_ssm
            and cfg.sliding_window is None)


@dataclasses.dataclass
class PrefixHit:
    """One admission's radix-cache match (:class:`PrefixCache`)."""

    pages: List[int]                     # full shared pages, block order
    matched_len: int                     # prompt tokens covered in total
    partial: Optional[Tuple[int, int]]   # (page, n_tokens) tail page

    @property
    def n_full(self) -> int:
        """Full matched pages: the lane's allocation discount (a partial
        page is not discounted: its copy-on-write split draws a fresh
        page from the reservation)."""
        return len(self.pages)


def _bucket_len(n: int, floor: int = 8) -> int:
    """Smallest power-of-two >= n (>= floor) -- the prefill shape bucket."""
    b = floor
    while b < n:
        b <<= 1
    return b


#: paged pool holding each dense cache entry
_POOL_KEY = {"k": "k_pages", "v": "v_pages", "k_scale": "k_scale_pages",
             "v_scale": "v_scale_pages"}


class ServeEngine:
    """Continuous batcher around a decoder (dense, moe, ssm, hybrid or
    vlm; a vlm is served as its text decoder, with no vision input, as
    in the reference).  An encoder-decoder (whisper) is refused by name:
    the reference's engine builds a decoder cache and cannot serve one
    either; drive it through ``Model.encode``, ``Model.init_cache(enc=
    ...)`` and ``Model.decode_n_steps``.

    ``n_lanes`` bounds the decode batch width; with ``paged=True``,
    ``n_pages`` bounds KV bytes (default: ``n_lanes`` full contexts).
    ``dispatch_n`` is the number of tokens each lane advances per
    dispatch.  ``temperature`` > 0 samples, keyed from ``rng_seed``;
    ``prefill_bucketing=False`` prefills each prompt at its own length.
    ``stats`` holds the counters named in :data:`STATS_SCHEMA`;
    ``prefill_compiles`` counts distinct prefill shapes (the reference
    compiles once per shape; a CUDA graph captured for each on the
    card), ``decode_compiles`` the distinct dispatch
    sizes (a CUDA graph captured for each on the card; the reference
    compiles its decode scan once per size), ``ssm_prefill_compiles``
    the distinct prompt-streaming buckets of an ssm model (the
    reference compiles its streaming scan once per bucket).

    ``timed=True`` synchronises the device around each prefill and each
    decode dispatch and records host-clock seconds in ``timings``
    (``prefill`` per bucket, ``decode`` per dispatch with
    ``decode_replayed`` beside it, True where the dispatch was a graph
    replay, and for an ssm model ``ssm_stream`` per prompt: the state
    rebuild, inside the prefill's time); off by default, since the syncs
    cost throughput.  ``prefill_replayed`` holds, per bucket, one flag a
    prefill, True where it was a graph replay, timed or not.  A
    capture's own seconds stay out of those and go to
    ``timings["capture"]``, by graph (``n_steps``, ``("prefill",
    bucket)``, or ``"stream_step"`` for the stream's step), whether timed
    or not.

    ``prefix_sharing=True`` (paged, dense family without a window:
    :func:`prefix_sharing_supported`) keeps a radix cache of prompt
    pages (:class:`PrefixCache`): an admission maps the longest cached
    prefix into the lane's block table by refcount, copies a shared
    partial tail page on write, and streams only the unmatched tail
    through the batch-1 decode step (int8 KV: full pages only, and the
    batched prefill replays for the logits).  ``evict`` / ``restore``
    move a live lane of any paged engine through a host
    :class:`LaneCheckpoint`.  Timed, a streamed tail's seconds go to
    ``timings["prefix_stream"]`` and its token count to
    ``timings["prefix_tail_tokens"]``.

    Observability and resilience (the reference's, name for name;
    :mod:`repro_torch.obs`): every counter lives in ``registry`` (a
    fresh :class:`MetricsRegistry` unless one is shared) as
    ``<name>.<suffix>`` of :data:`STATS_SCHEMA`, and ``stats`` is a
    :class:`StatsView` over them; a paged engine publishes its pool as
    ``<name>.pool.pages.*`` callback gauges.  ``tracer`` (a
    :class:`SpanTracer`, disabled by default) gets the reference's spans
    and instants on the engine's track (``name``) and its lanes'
    (:meth:`lane_track`).  All are host-side: none synchronises the
    device or enters a captured graph, so on the card

    * ``admit`` (with ``prefill.bucket``, ``prefix.cow`` and
      ``prefix.tail_prefill`` inside it) closes when the host has queued
      the admission's launches and copies, not when the device has run
      them (a prefix hit's tail stream reads nothing back either);
    * ``decode.dispatch`` covers the page mapping, the launch or graph
      replay, and the token read-back, which waits for the device: it
      measures the dispatch's latency as the host sees it;
    * ``preempt.evict`` includes the device-to-host copy of the lane's
      pages (a sync); ``preempt.restore`` only queues its copies.

    ``clock`` is the engine's one clock (default the tracer's,
    ``time.perf_counter``): spans, SLO observations, ``timed`` and the
    graph capture seconds all read it.  ``flight`` (a
    :class:`FlightRecorder`) taps the tracer and is dumped when an
    :class:`~repro_torch.analysis.invariants.InvariantError` escapes
    ``admit``, a dispatch, an evict or the sanitizer's crosscheck.
    ``slo`` (an :class:`~repro_torch.obs.slo.SLOController`) is fed
    TTFT and TPOT at each dispatch's drain and stepped once per
    dispatch.  ``ladder`` (a :class:`DegradationLadder`) makes
    :meth:`run` shed load under page pressure: smaller dispatches,
    deferred admissions, and at the top rung the lowest-priority lane
    evicted to a checkpoint and restored when pressure clears.
    ``sanitize=True`` (paged) shadows the pool with a strict
    :class:`PageSanitizer` fed by the pool's mutators and the engine's
    map/write/capture records, the write pages computed from the host
    mirrors of lengths and budgets, and cross-checked at every dispatch
    boundary.
    """

    #: flat stats key -> namespaced metric suffix (the reference's
    #: telemetry schema; full names prepend the engine's ``name``)
    STATS_SCHEMA = {
        "decode_dispatches": "decode.dispatches",
        "decode_steps": "decode.steps",
        "decode_compiles": "decode.compiles",
        "generated_tokens": "tokens.generated",
        "prefill_compiles": "prefill.compiles",
        "ssm_prefill_compiles": "prefill.ssm_compiles",
        "kv_pages_hwm": "kv.pages_hwm",
        "kv_admit_blocked": "kv.admit_blocked",
        "preemptions": "preempt.evictions",
        "restores": "preempt.restores",
        "pages_migrated": "preempt.pages_migrated",
        "retry_attempts": "retry.attempts",
        "retry_hedges": "retry.hedges",
        "admit_rejected": "admit.rejected",
        "degrade_transitions": "degrade.transitions",
        "degrade_sheds": "degrade.sheds",
        "prefix_hits": "prefix.hits",
        "prefix_misses": "prefix.misses",
        "prefix_tokens_matched": "prefix.tokens_matched",
        "prefix_pages_shared": "prefix.pages_shared",
        "prefix_pages_saved": "prefix.pages_saved",
        "prefix_cow_copies": "prefix.cow_copies",
        "prefix_evictions": "prefix.evictions",
    }

    def __init__(self, cfg: ModelConfig, params, n_lanes: int = 4,
                 max_len: int = 512, temperature: float = 0.0,
                 rng_seed: int = 0, dispatch_n: int = 8,
                 prefill_bucketing: bool = True, paged: bool = False,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_sharing: bool = False, sanitize: bool = False,
                 tracer: Optional[SpanTracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 name: str = "serve",
                 ladder: Optional[DegradationLadder] = None,
                 clock: Optional[Callable[[], float]] = None,
                 flight: Optional[FlightRecorder] = None,
                 slo=None, device=None, timed: bool = False):
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name}: an encoder-decoder (family {cfg.family!r}) "
                f"is not served by ServeEngine, as in the reference; run "
                f"Model.encode, Model.init_cache(enc=...) and "
                f"Model.decode_n_steps")
        self.device = resolve_device(device)
        param_dev = next(params.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"params on {param_dev}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        # graceful-degradation ladder (None: run() never sheds)
        self.ladder = ladder
        if ladder is not None:
            ladder.name = name
        self.model = build_model(cfg)
        self.params = params
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.temperature = float(temperature)
        self.dispatch_n = max(1, dispatch_n)
        self.prefill_bucketing = prefill_bucketing
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self._sanitizer: Optional[PageSanitizer] = None
        if self.paged:
            # O(1) recurrent state of an ssm model needs no pages
            self._bt_width = (0 if cfg.attn_free else
                              paged_capacity(max_len, cfg) // page_size)
            if n_pages is None:
                n_pages = n_lanes * self._bt_width
            invariant(n_pages >= self._bt_width, (
                "page pool smaller than one full context: no request "
                "could ever be admitted"), n_pages=n_pages,
                bt_width=self._bt_width)
            self.pool: Optional[PagePool] = PagePool(n_pages, page_size)
            # one extra physical page the allocator never hands out: a
            # DEAD lane still steps inside the batch and writes its
            # (frozen) slot through its block table -- pointing dead
            # rows at the scratch page keeps that write off pages
            # re-issued to a live lane
            self._scratch_page = n_pages
            if sanitize:
                self._sanitizer = PageSanitizer(strict=True)
                self.pool.monitor = self._sanitizer
                self._sanitizer.record(
                    "init", n_pages=n_pages, page_size=page_size,
                    scratch=self._scratch_page)
            self.cache = self.model.init_paged_cache(
                n_lanes, max_len, page_size=page_size, n_pages=n_pages + 1,
                device=self.device)
            if "block_tables" in self.cache:
                self.cache["block_tables"].fill_(self._scratch_page)
        else:
            self._bt_width = 0
            self.pool = None
            self.cache = self.model.init_cache(n_lanes, max_len,
                                               device=self.device)
        # as in the reference, a fixed-lane engine ignores the flag
        self.prefix_cache: Optional[PrefixCache] = None
        if self.paged and prefix_sharing:
            invariant(prefix_sharing_supported(cfg), (
                "prefix sharing needs the whole prompt context "
                "page-resident and append-only (no sliding window, no "
                "recurrent state)"), family=cfg.family)
            self.prefix_cache = PrefixCache(self.pool, page_size)
        self._lane_pages: List[List[int]] = [[] for _ in range(n_lanes)]
        self._lane_reserved = [0] * n_lanes
        self._blocked_uids: set = set()
        self._len_host = np.zeros((n_lanes,), np.int64)
        self.lane_req: List[Optional[Request]] = [None] * n_lanes
        dev = self.device
        base = trng.PRNGKey(rng_seed, device=dev)
        self._rng_decode = trng.fold_in(base, 0)
        self._rng_prefill = trng.fold_in(base, 1)
        self._next_token = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        self._remaining = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        self._remaining_host = np.zeros((n_lanes,), np.int64)
        # per-lane sampling identity: the admission index seeds the
        # lane's key lineage, tok_idx counts its generated tokens
        self._lane_seed = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        self._tok_idx = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        self._admit_count = 0
        self._buckets: set = set()
        #: each prefill bucket's input buffers (``_prefill_inputs``)
        self._prefill_in: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._tail_buckets: set = set()
        if cfg.has_ssm or self.prefix_cache is not None:
            # the prompt stream's batch-1 cache and input token, at
            # addresses a captured decode step replays: the shared page
            # pools themselves, a batch-1 row of everything per lane (a
            # sharing engine streams a prompt's unmatched tail on it)
            self._stream_lane = {}
            for key, t in self.cache.items():
                if key in _POOL_KEY.values():
                    self._stream_lane[key] = t
                elif key in ("len", "block_tables"):
                    self._stream_lane[key] = torch.zeros_like(t[:1])
                else:
                    self._stream_lane[key] = torch.zeros_like(t[:, :1])
            self._stream_tok = torch.zeros(1, dtype=torch.int32, device=dev)
        # telemetry: every counter lives in the registry under
        # "<name>.<suffix>"; stats is a MutableMapping view over them
        self.name = name
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else SpanTracer(
            enabled=False, clock=clock, registry=self.registry)
        # one clock per engine: spans, SLO observations, timed seconds
        # and graph capture seconds all read it
        self.clock = clock if clock is not None else self.tracer.clock
        self.flight = flight
        if flight is not None:
            flight.attach(tracer=self.tracer)
        self.slo = slo
        self._admit_t: Dict[int, float] = {}
        keymap = {k: f"{name}.{suffix}"
                  for k, suffix in self.STATS_SCHEMA.items()}
        for metric_name in keymap.values():
            # a fresh engine starts its counters at zero even on a
            # shared registry
            self.registry.counter(metric_name).set(0)
        self._stats = StatsView(self.registry, keymap)
        if self.paged:
            self.pool.bind_registry(self.registry, prefix=f"{name}.pool")
        if self.prefix_cache is not None:
            self.registry.gauge(
                f"{name}.prefix.cached_pages",
                fn=lambda: self.prefix_cache.n_pages,
                help="pool pages the radix prompt cache holds a ref on")
        self.graphs = StepGraphs(dev, clock=self.clock)
        self.timed = timed
        self.timings: Dict[str, Any] = {"prefill": defaultdict(list),
                                        "prefill_replayed": defaultdict(list),
                                        "decode": [], "decode_replayed": [],
                                        "ssm_stream": [],
                                        "prefix_stream": [],
                                        "prefix_tail_tokens": [],
                                        "capture": self.graphs.capture_s}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- telemetry --------------------------------------------------------
    @property
    def stats(self) -> StatsView:
        """The flat stats mapping, backed by the metrics registry."""
        return self._stats

    @stats.setter
    def stats(self, values: Dict[str, Any]) -> None:
        # the bench reset idiom (`eng.stats = {k: 0 for k in eng.stats}`)
        # writes values through the view; the schema itself is fixed
        for k, v in values.items():
            self._stats[k] = v

    def lane_track(self, lane: int) -> str:
        """Trace track name for one lane of this engine."""
        return f"{self.name}/lane{lane}"

    # -- admission --------------------------------------------------------
    def free_lanes(self) -> List[int]:
        return [i for i, r in enumerate(self.lane_req) if r is None]

    def live_lanes(self) -> List[int]:
        return [i for i, r in enumerate(self.lane_req) if r is not None]

    def _pages_needed(self, positions: int) -> int:
        """Pages backing ``positions`` cache slots (capped at the table
        width: a sliding-window lane rotates within its page set; 0 on
        the fixed-lane layout and for an ssm model, whose width is 0)."""
        ps = self.page_size
        return min(-(-int(positions) // ps), self._bt_width)

    def _trunc_prompt(self, req: Request) -> np.ndarray:
        """The prompt as the lane holds it: a cache cannot back more than
        ``max_len - 1`` prompt positions and still decode, so over-long
        prompts keep their TAIL (llama.cpp-style truncation)."""
        limit = self.max_len - 1
        prompt = req.prompt
        return prompt[-limit:] if prompt.shape[0] > limit else prompt

    def _trunc_plen(self, req: Request) -> int:
        return min(int(req.prompt.shape[0]), self.max_len - 1)

    def admission_pages(self, req: Request) -> int:
        """Worst-case page need of ``req`` (prompt + full budget + the
        trailing write slot), clamped to ``max_len`` positions since
        generation stops at the length cap regardless of budget."""
        worst = min(self._trunc_plen(req) + req.max_new_tokens + 1,
                    self.max_len)
        return self._pages_needed(worst)

    def can_admit(self, req: Request) -> bool:
        if not self.free_lanes():
            return False
        if not self.paged:
            return True
        return self.admission_pages(req) <= self.pool.available()

    def admit(self, req: Request) -> bool:
        lanes = self.free_lanes()
        if not lanes:
            return False
        lane = lanes[0]
        hit: Optional[PrefixHit] = None
        if self.paged:
            need = self.admission_pages(req)
            reserve = need
            if self.prefix_cache is not None:
                # every full matched page is one the request never
                # allocates: the reservation shrinks by exactly that
                hit = self._prefix_match(req)
                reserve = need - hit.n_full
            if not self.pool.reserve(reserve):
                if self.prefix_cache is not None \
                        and self.prefix_cache.n_pages:
                    # cached-but-unmapped prefix pages go first under
                    # pressure; eviction may drop matched nodes, so match
                    # again after
                    self._trim_prefix_cache(reserve)
                    hit = self._prefix_match(req)
                    reserve = need - hit.n_full
                if not self.pool.reserve(reserve):
                    # a lane is free but the KV bytes are not; counted
                    # once per blocked episode, not per retry
                    if req.uid not in self._blocked_uids:
                        self._blocked_uids.add(req.uid)
                        self.stats["kv_admit_blocked"] += 1
                        self.tracer.instant("admit.blocked",
                                            track=self.lane_track(lane),
                                            uid=req.uid, need_pages=need)
                    return False
            self._blocked_uids.discard(req.uid)
        if self.slo is not None and req.uid not in self._admit_t:
            # TTFT starts at the first successful admission (a restore
            # after an evict keeps the original mark)
            self._admit_t[req.uid] = self.clock()
        with flight_guard(self.flight, op="admit",
                          registry=self.registry), \
                self.tracer.span("admit", track=self.lane_track(lane),
                                 uid=req.uid):
            if self.paged:
                self._lane_reserved[lane] = reserve
                self._lane_pages[lane] = []
                if hit is None or hit.matched_len == 0:
                    # map the prompt's pages plus the first decode write
                    # slot; generation growth maps the rest at dispatch
                    # boundaries
                    self._map_pages(lane, self._pages_needed(
                        self._trunc_plen(req) + 1))
            self._lane_seed[lane] = self._admit_count
            self._tok_idx[lane] = 0
            if hit is not None and hit.matched_len > 0:
                self._prefill_hit(req, lane, hit)
            else:
                if self.prefix_cache is not None:
                    self.stats["prefix_misses"] += 1
                self._prefill_into_lane(req, lane)
            if self.prefix_cache is not None:
                self._cache_lane_prefix(req, lane)
            self.lane_req[lane] = req
            self._remaining[lane] = req.max_new_tokens
            self._remaining_host[lane] = req.max_new_tokens
        return True

    def _map_pages(self, lane: int, target: int) -> None:
        """Grow ``lane``'s block table to ``target`` mapped pages, drawing
        on the admission-time reservation (infallible mid-flight)."""
        have = len(self._lane_pages[lane])
        if target <= have:
            return
        new = self.pool.alloc(target - have, holder=lane)
        self._lane_reserved[lane] -= len(new)
        self._lane_pages[lane].extend(new)
        self.cache["block_tables"][lane, have:target] = torch.tensor(
            new, dtype=torch.int32).to(self.device)
        s = self._sanitizer
        if s is not None:
            s.record("map", lane=lane, pages=list(new))
        self.stats["kv_pages_hwm"] = max(self.stats["kv_pages_hwm"],
                                         self.pool.hwm)

    # -- prefix sharing ----------------------------------------------------
    def _prefix_match(self, req: Request) -> PrefixHit:
        """Match the (truncated) prompt against the radix cache.  int8
        caches match full pages only: their hit replays the batched
        prefill for the logits, so a partial page would save nothing and
        still cost a copy-on-write split."""
        pages, matched, partial = self.prefix_cache.match(
            self._trunc_prompt(req),
            allow_partial=self.cfg.kv_quant != "int8")
        return PrefixHit(pages=pages, matched_len=matched, partial=partial)

    def _trim_prefix_cache(self, target_available: int) -> int:
        """Evict LRU cache leaves until the pool can cover a
        ``target_available``-page reservation (or the cache is empty).
        A dropped page refills the free list only once no lane maps it,
        hence the loop on actual availability."""
        dropped = 0
        while (self.pool.available() < target_available
               and self.prefix_cache.n_pages):
            if not self.prefix_cache.evict_lru():
                break
            dropped += 1
            self.stats["prefix_evictions"] += 1
        return dropped

    def _prefill_hit(self, req: Request, lane: int, hit: PrefixHit) -> None:
        """Admit ``req`` over a cache hit: map the matched pages into the
        lane's block table (a refcount each, no copy), split a matched
        partial tail page on write (the lane's first append diverges
        from its donor's), map the rest of the prompt's pages, then make
        the first token: in full precision by streaming only the
        unmatched tail through the batch-1 decode step; with int8 KV by
        replaying the batched prefill (a streamed tail would attend to
        the dequantized prefix, the unshared engine's prefill to the
        full-precision one) and scattering the blocks the match did not
        cover."""
        prompt = self._trunc_prompt(req)
        plen = int(prompt.shape[0])
        shared = list(hit.pages)
        if hit.partial is not None:
            shared.append(hit.partial[0])
        self.pool.share(shared, holder=lane)
        self._lane_pages[lane] = list(shared)
        self.cache["block_tables"][lane, :len(shared)] = torch.tensor(
            shared, dtype=torch.int32).to(self.device)
        s = self._sanitizer
        if s is not None:
            s.record("map", lane=lane, pages=list(shared))
        if hit.partial is not None:
            self._cow_lane_page(lane, len(hit.pages))
        self._map_pages(lane, self._pages_needed(plen + 1))
        self._len_host[lane] = plen
        self.stats["prefix_hits"] += 1
        self.stats["prefix_tokens_matched"] += hit.matched_len
        self.stats["prefix_pages_shared"] += len(shared)
        self.stats["prefix_pages_saved"] += hit.n_full
        self.tracer.instant("prefix.hit", track=self.lane_track(lane),
                            uid=req.uid, matched_tokens=hit.matched_len,
                            shared_pages=len(shared))
        if self.cfg.kv_quant == "int8":
            # full pages only: the batched prefill gives the exact logits
            # and scatters the blocks the match did not cover
            self._prefill_prompt(prompt, lane, first_block=hit.n_full)
        else:
            self._prefill_hit_stream(prompt, lane, plen, hit.matched_len)

    def _cow_lane_page(self, lane: int, idx: int) -> None:
        """Copy-on-write split of the lane's shared block ``idx``: a fresh
        page from the reservation takes a copy of the shared page's
        contents (every pool: K/V and int8 scales) and the block-table
        entry, both in place, since captured graphs read the pools and
        tables at their addresses.  The copy is queued in stream order,
        so it snapshots the donor's writes so far."""
        old = self._lane_pages[lane][idx]
        with self.tracer.span("prefix.cow", track=self.lane_track(lane),
                              page=old):
            new = self.pool.cow(old, holder=lane)
            self._lane_reserved[lane] -= 1
            self._lane_pages[lane][idx] = new
            for key in _POOL_KEY.values():
                if key in self.cache:
                    self.cache[key][:, new].copy_(self.cache[key][:, old])
            self.cache["block_tables"][lane, idx] = new
            s = self._sanitizer
            if s is not None:
                s.record("write", lane=lane, pages=[new], kind="cow_copy")
        self.stats["prefix_cow_copies"] += 1
        self.stats["kv_pages_hwm"] = max(self.stats["kv_pages_hwm"],
                                         self.pool.hwm)

    def _prefill_hit_stream(self, prompt: np.ndarray, lane: int,
                            plen: int, matched_len: int) -> None:
        """Full-precision hit: stream only the unmatched tail through the
        batch-1 decode step from ``len = matched_len``, over a copy of
        the lane's block-table row and the shared pools, attending to the
        matched span already in the pages.  The reference scans the
        tail's shape bucket once per compile (``ssm_prefill_compiles``
        counts the distinct tail buckets); these steps stop at ``plen``,
        as the ssm stream does."""
        tail = np.asarray(prompt[matched_len:], np.int32)
        tlen = int(tail.shape[0])
        invariant(tlen >= 1, "prefix match must leave a tail token",
                  plen=plen, matched_len=matched_len)
        bucket = _bucket_len(tlen) if self.prefill_bucketing else tlen
        self._tail_buckets.add(bucket)
        self.stats["ssm_prefill_compiles"] = len(self._tail_buckets)
        s = self._sanitizer
        if s is not None:
            # the streamed tail writes positions [matched_len, plen) and
            # the first decode write slot's page
            pages = self._lane_pages[lane][matched_len // self.page_size:
                                           self._pages_needed(plen + 1)]
            if pages:
                s.record("write", lane=lane, pages=list(pages),
                         kind="prefill")
        if self.timed:
            self._sync()
            t0 = self.clock()
        captured = "stream_step" in self.graphs.capture_s
        buf = self._stream_lane
        buf["len"].fill_(matched_len)
        buf["block_tables"].copy_(self.cache["block_tables"][lane:lane + 1])
        with self.tracer.span("prefix.tail_prefill",
                              track=self.lane_track(lane),
                              bucket=bucket, tlen=tlen):
            logits = self._replay_stream(tail)
        self.cache["len"][lane] = plen
        self._set_first_token(logits, lane)
        if self.timed:
            self._sync()
            capture = (0.0 if captured else
                       self.graphs.capture_s.get("stream_step", 0.0))
            self.timings["prefix_stream"].append(self.clock() - t0
                                                 - capture)
            self.timings["prefix_tail_tokens"].append(tlen)

    def _cache_lane_prefix(self, req: Request, lane: int) -> None:
        """Offer the freshly prefilled lane's prompt pages to the radix
        cache (which takes its own reference on each page it keeps)."""
        prompt = self._trunc_prompt(req)
        self.prefix_cache.insert(
            prompt, int(prompt.shape[0]), self._lane_pages[lane],
            allow_partial=self.cfg.kv_quant != "int8")

    # -- prefill ----------------------------------------------------------
    def _prefill_into_lane(self, req: Request, lane: int) -> None:
        prompt = self._trunc_prompt(req)
        self._len_host[lane] = int(prompt.shape[0])
        self._prefill_prompt(prompt, lane)

    def _prefill_prompt(self, prompt: np.ndarray, lane: int,
                        first_block: int = 0) -> None:
        """The batched prefill of ``prompt`` in its shape bucket, its KV
        scattered into the lane from block ``first_block`` on (paged;
        earlier blocks are shared prefix pages), and the first token
        sampled (an ssm or hybrid lane streams the prompt first)."""
        plen = int(prompt.shape[0])
        bucket = _bucket_len(plen) if self.prefill_bucketing else plen
        self._buckets.add(bucket)
        tokens, last_pos = self._prefill_inputs(bucket)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = prompt
        if self.timed:
            self._sync()
            t0 = self.clock()
            captured = sum(self.graphs.capture_s.values())
        with self.tracer.span("prefill.bucket", track=self.lane_track(lane),
                              bucket=bucket, plen=plen):
            # the graph's inputs are written in place outside it
            tokens.copy_(torch.from_numpy(padded))
            last_pos.fill_(plen - 1)
            (logits, kv), first = self.graphs.run(
                ("prefill", bucket), lambda: self._prefill_block(bucket))
            if first:
                self.stats["prefill_compiles"] += 1
            self.timings["prefill_replayed"][bucket].append(
                self.graphs.on_card and not first)
            # a replay's outputs are the graph's own tensors: everything
            # that reads them is queued here, before any other replay
            if kv is not None:
                if self.paged:
                    self._scatter_prompt_paged(kv, lane, plen, first_block)
                else:
                    self._scatter_prompt_dense(kv, lane, plen)
        if self.cfg.has_ssm:
            # the recurrent state is rebuilt by streaming the prompt
            # through the decode step; its logits give the first token
            self._stream_ssm_prompt(prompt, lane)
        else:
            self.cache["len"][lane] = plen
            self._set_first_token(logits, lane)
        if self.timed:
            self._sync()
            captured = sum(self.graphs.capture_s.values()) - captured
            self.timings["prefill"][bucket].append(self.clock() - t0
                                                   - captured)

    def _prefill_inputs(self, bucket: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bucket's prefill inputs, made on its first prompt and kept
        at their addresses for the engine's life (its graph reads them):
        the (1, bucket) int32 padded tokens and the (1,) int64 last
        position."""
        bufs = self._prefill_in.get(bucket)
        if bufs is None:
            bufs = (torch.zeros((1, bucket), dtype=torch.int32,
                                device=self.device),
                    torch.zeros((1,), dtype=torch.int64, device=self.device))
            self._prefill_in[bucket] = bufs
        return bufs

    def _prefill_block(self, bucket: int):
        """The prefill of one bucket over its input buffers and the
        weights alone: ``(logits (1, V), (k, v) or None)``.  On the card
        it is captured as the ``("prefill", bucket)`` graph (the
        reference's jitted prefill), so it makes no tensor from host
        data."""
        tokens, last_pos = self._prefill_in[bucket]
        return self.model.prefill(self.params, tokens, last_pos=last_pos)

    def _prompt_kv_views(self, kv, plen: int, smax: int):
        """Last ``take = min(plen, smax)`` prompt positions of the
        prefill KV, placed at their ring slots (``slot = position mod
        smax``), so the decode step's ring write (same formula) evicts
        the true oldest position, and quantized when the cache is int8
        (:func:`quantize_kv_token`, the scales the decode write uses).

        Returns (entries, take): ``entries`` maps the dense cache key
        (k, v[, k_scale, v_scale]) to an (L, Hkv, take, D or 1) tensor.
        """
        k, v = kv                       # (L, 1, Hkv, S_bucket, D)
        take = min(plen, smax)
        kv = torch.stack([k[:, 0, :, plen - take:plen],
                          v[:, 0, :, plen - take:plen]])
        if take == smax:
            shift = plen % smax
            if shift:
                kv = torch.roll(kv, shift, dims=3)
        if self.cfg.kv_quant == "int8":
            vals, scales = quantize_kv_token(kv)
            return {"k": vals[0], "v": vals[1], "k_scale": scales[0],
                    "v_scale": scales[1]}, take
        return {"k": kv[0], "v": kv[1]}, take

    def _scatter_prompt_dense(self, kv, lane: int, plen: int) -> None:
        """Write the prompt KV into slots ``[0, take)`` of the lane's row
        of the dense cache (positions past ``take`` keep stale values
        that no read reaches)."""
        entries, take = self._prompt_kv_views(kv, plen,
                                              self.cache["k"].shape[3])
        for key, src in entries.items():
            dst = self.cache[key]
            dst[:, lane, :, :take] = src.to(dst.dtype)

    def _scatter_prompt_paged(self, kv, lane: int, plen: int,
                              first_block: int = 0) -> None:
        """Write the prompt KV (and its scales when int8) into the lane's
        mapped pages, in one indexed copy per pool.  ``first_block``
        skips blocks backed by shared prefix pages: their bytes are the
        donor's, and writing them would change every lane mapping
        them."""
        ps = self.page_size
        entries, take = self._prompt_kv_views(kv, plen, ps * self._bt_width)
        n_pg = -(-take // ps)
        if first_block >= n_pg:
            return
        pad = n_pg * ps - take
        written = self._lane_pages[lane][first_block:n_pg]
        pages = torch.tensor(written, dtype=torch.long).to(self.device)
        for key, src in entries.items():
            pool = self.cache[_POOL_KEY[key]]
            if pad:
                src = torch.nn.functional.pad(src, (0, 0, 0, pad))
            n_l, hkv, _, d = src.shape
            seg = src.reshape(n_l, hkv, n_pg, ps, d).permute(0, 2, 1, 3, 4)
            pool[:, pages] = seg[:, first_block:].to(pool.dtype)
        s = self._sanitizer
        if s is not None and written:
            s.record("write", lane=lane, pages=list(written), kind="prefill")

    def _stream_step(self) -> torch.Tensor:
        """One batch-1 decode step of the prompt stream over its own
        buffers: the token in ``_stream_tok`` advances ``_stream_lane``'s state
        and K/V (in place) and length; returns the logits."""
        logits, cache = self.model.decode_step(self.params, self._stream_lane,
                                               self._stream_tok)
        self._stream_lane["len"].copy_(cache["len"])
        return logits

    def _replay_stream(self, tokens: np.ndarray) -> torch.Tensor:
        """Step the batch-1 buffers through ``tokens``, one decode step a
        token (on the card a replay of the captured ``"stream_step"`` graph
        after the engine's first); returns the last step's logits."""
        toks = torch.from_numpy(tokens.astype(np.int32)).to(self.device)
        for t in range(int(toks.shape[0])):
            self._stream_tok.copy_(toks[t:t + 1])
            logits, _ = self.graphs.run("stream_step", self._stream_step)
        return logits

    def _stream_ssm_prompt(self, prompt: np.ndarray, lane: int) -> None:
        """Rebuild ``lane``'s recurrent state from zeros by streaming the
        prompt through the decode step on the stream's batch-1 buffers,
        copy the state into the lane, and sample the first token from
        the logits at ``plen - 1``.  On the card every step after the
        engine's first replays one captured step; that graph is not a
        decode compile.

        A hybrid lane's K/V is rebuilt by the same steps from length 0:
        dense, in the batch-1 row, whose slots ``[0, min(plen, S))`` then
        replace the lane's (the ones the prefill's scatter wrote); paged,
        straight into the lane's own pages through a batch-1 copy of its
        block-table row.  A step reads only the slots it and the steps
        before it wrote.

        The reference scans the whole shape bucket with the pad steps'
        state masked off, one compile per bucket
        (``ssm_prefill_compiles``); these steps stop at ``plen``, which
        leaves the same state, K/V and logits (a pad step writes only
        the slot the first decode step writes again before reading it).
        Its buckets are the prefill's (``_prefill_into_lane`` counted
        this one)."""
        plen = int(prompt.shape[0])
        self.stats["ssm_prefill_compiles"] = len(self._buckets)
        if self.timed:
            self._sync()
            t0 = self.clock()
        captured = "stream_step" in self.graphs.capture_s
        buf = self._stream_lane
        # the stream starts from zero state: a re-admitted lane must NOT
        # inherit the previous request's
        for key in ("ssm_h", "ssm_conv", "len"):
            buf[key].zero_()
        if "block_tables" in buf:
            buf["block_tables"].copy_(self.cache["block_tables"][lane:lane + 1])
        logits = self._replay_stream(prompt)
        for key in ("ssm_h", "ssm_conv"):
            self.cache[key][:, lane].copy_(buf[key][:, 0])
        if "k" in buf:
            take = min(plen, buf["k"].shape[3])
            for key in _POOL_KEY:
                if key in buf:
                    self.cache[key][:, lane, :, :take].copy_(
                        buf[key][:, 0, :, :take])
        self.cache["len"][lane] = plen
        self._set_first_token(logits, lane)
        s = self._sanitizer
        if s is not None and self._lane_pages[lane]:
            # a hybrid lane streams the whole prompt through the decode
            # step; every mapped page is this lane's alone
            s.record("write", lane=lane, pages=list(self._lane_pages[lane]),
                     kind="prefill")
        if self.timed:
            self._sync()
            capture = (0.0 if captured else
                       self.graphs.capture_s.get("stream_step", 0.0))
            self.timings["ssm_stream"].append(self.clock() - t0
                                              - capture)

    def _set_first_token(self, logits: torch.Tensor, lane: int) -> None:
        key = (trng.fold_in(self._rng_prefill, self._admit_count)
               if self.temperature > 0.0 else None)
        self._admit_count += 1
        self._next_token[lane] = sample_tokens(logits, key,
                                               self.temperature)[0]

    # -- stepping ----------------------------------------------------------
    def _dispatch_size(self, n: Optional[int]) -> int:
        """Tokens per dispatch: dispatch_n, shrunk to a power of two when
        every live lane owes fewer tokens."""
        n = n or self.dispatch_n
        live = self.live_lanes()
        max_rem = int(self._remaining_host[live].max()) if live else 0
        return min(n, _bucket_len(max(max_rem, 1), floor=1))

    def map_dispatch_pages(self, n: int) -> None:
        """Paged: map the pages an ``n``-step dispatch can write into
        BEFORE it runs (a live lane's slots past its mapped pages would
        go to the shared scratch page); the admission-time reservation
        makes this infallible.  A no-op on the fixed-lane layout."""
        if not self.paged:
            return
        for lane in self.live_lanes():
            steps = min(n, int(self._remaining_host[lane]))
            self._map_pages(lane, self._pages_needed(
                int(self._len_host[lane]) + steps + 1))

    def _decode_block(self, n: int) -> torch.Tensor:
        """The dispatch, over the engine's own tensors: ``n`` decode steps
        of every lane (``decode_n_steps``, the reference's semantics),
        then the new lengths, next tokens, budgets and token indices
        copied into the tensors they were read from, so no address moves
        (a CUDA graph replays them).  Returns the (2n + 1, B) int32 block
        of tokens, valid flags and budgets that the host drains."""
        toks, valid, nxt, cache, rem, idx = self.model.decode_n_steps(
            self.params, self.cache, self._next_token, self._rng_decode,
            self._remaining, self._lane_seed, self._tok_idx, n_steps=n,
            temperature=self.temperature, len_cap=self.max_len - 1)
        self.cache["len"].copy_(cache["len"])
        self._next_token.copy_(nxt)
        self._remaining.copy_(rem)
        self._tok_idx.copy_(idx)
        return torch.cat([toks, valid.to(torch.int32), rem[None]])

    def decode_n(self, n: Optional[int] = None) -> Dict[int, List[int]]:
        """Advance all live lanes up to ``n`` tokens in ONE dispatch.

        Returns {uid: [tokens]} for this block; requests that exhaust
        their budget (or the cache) are retired at the boundary."""
        live = self.live_lanes()
        if not live:
            return {}
        n = self._dispatch_size(n)
        t_disp0 = self.clock() if self.slo is not None else 0.0
        with flight_guard(self.flight, op="decode.dispatch",
                          registry=self.registry), \
                self.tracer.span(
                    "decode.dispatch", track=self.name, n_steps=n,
                    n_live=len(live),
                    uids=tuple(self.lane_req[i].uid for i in live)):
            self.map_dispatch_pages(n)
            if self._sanitizer is not None:
                self._record_dispatch_writes(live, n)
            if self.timed:
                self._sync()
                t0 = self.clock()
            block, first = self.graphs.run(n, lambda: self._decode_block(n))
            if first:
                self.stats["decode_compiles"] += 1
            self.stats["decode_dispatches"] += 1
            self.stats["decode_steps"] += n
            # one host transfer drains the whole block
            block = block.cpu().numpy()
            if self.timed:
                capture = self.graphs.capture_s.get(n, 0.0) if first else 0.0
                self.timings["decode"].append(self.clock() - t0 - capture)
                self.timings["decode_replayed"].append(self.graphs.on_card
                                                       and not first)
        toks_h = block[:n]
        valid_h = block[n:2 * n].astype(bool)
        self._remaining_host = block[2 * n].astype(np.int64)
        slo = self.slo
        if slo is not None:
            now = self.clock()
            disp_s = now - t_disp0
        out: Dict[int, List[int]] = {}
        for lane in live:
            req = self.lane_req[lane]
            seq = [int(t) for t in toks_h[valid_h[:, lane], lane]]
            first_tok = not req.generated and bool(seq)
            req.generated.extend(seq)
            out[req.uid] = seq
            self.stats["generated_tokens"] += len(seq)
            # the device length advanced once per valid sample
            self._len_host[lane] += len(seq)
            if first_tok:
                self.tracer.instant("first_token",
                                    track=self.lane_track(lane),
                                    uid=req.uid)
                if slo is not None:
                    t_admit = self._admit_t.pop(req.uid, None)
                    if t_admit is not None:
                        slo.monitor.observe_ttft(now - t_admit, t=now)
            if slo is not None and seq:
                slo.monitor.observe_tpot(disp_s / len(seq), t=now)
            if self._remaining_host[lane] <= 0:
                req.done = True
                self.tracer.instant("retire", track=self.lane_track(lane),
                                    uid=req.uid, gen=len(req.generated))
                self._release_lane(lane)
        if slo is not None:
            slo.step(now)
        if self._sanitizer is not None:
            # dispatch boundary: the shadow state must equal the pool
            with flight_guard(self.flight, op="sanitizer.crosscheck",
                              registry=self.registry):
                self._sanitizer.crosscheck(self.pool)
        return out

    def _record_dispatch_writes(self, live: List[int], n: int) -> None:
        """Sanitizer records of the pages an ``n``-step dispatch writes,
        per live lane, from the host mirrors of length and budget (no
        device read): the slots ``[len, len + steps]``, or a windowed
        lane's whole page set, which its ring write rotates through."""
        for lane in live:
            steps = min(n, int(self._remaining_host[lane]))
            start = int(self._len_host[lane])
            if self.cfg.sliding_window is not None:
                pages = list(self._lane_pages[lane])
            else:
                pages = self._lane_pages[lane][
                    start // self.page_size:
                    self._pages_needed(start + steps + 1)]
            if pages:
                self._sanitizer.record("write", lane=lane, pages=pages,
                                       kind="decode")

    def _release_lane(self, lane: int) -> None:
        """Return a lane to the DEAD state (retirement and eviction both
        end here): zero its length (so the length-aware kernel reads
        nothing of the stale context); when paged, drop the lane's
        reference on its pages (a page another lane or the prefix cache
        still maps survives) and its reservation, and point its
        block-table row at the scratch page (its old page ids may be
        re-issued while the dead lane keeps stepping)."""
        self.lane_req[lane] = None
        self.cache["len"][lane] = 0
        self._len_host[lane] = 0
        if self.paged:
            self.pool.free(self._lane_pages[lane], holder=lane)
            self.pool.unreserve(self._lane_reserved[lane])
            self._lane_pages[lane] = []
            self._lane_reserved[lane] = 0
            if "block_tables" in self.cache:
                self.cache["block_tables"][lane] = self._scratch_page

    def lane_pages(self, lane: int) -> List[int]:
        """Page ids mapped by ``lane``'s block table, in logical order."""
        return list(self._lane_pages[lane])

    def lane_context(self, lane: int) -> int:
        """Live context length of ``lane`` (host mirror, no sync)."""
        return int(self._len_host[lane])

    # -- preemption: evict and restore ---------------------------------------
    def evict(self, lane: int) -> LaneCheckpoint:
        """Checkpoint and release a live lane at a dispatch boundary.

        The checkpoint holds the request, its sampling identity, the
        token already sampled for the next step, and the lane's pages
        gathered through its block table (a deep copy: a page shared
        with the prefix cache or another lane is captured by value, and
        releasing the lane only drops its reference) and, for an ssm or
        hybrid lane, its recurrent state.  The lane's pages return to
        the pool at once; the scratch page is never captured."""
        invariant(self.paged, "evict/restore: paged engines only")
        req = self.lane_req[lane]
        invariant(req is not None, f"evict of idle lane {lane}", lane=lane)
        with flight_guard(self.flight, op="preempt.evict",
                          registry=self.registry), \
                self.tracer.span("preempt.evict",
                                 track=self.lane_track(lane), uid=req.uid,
                                 n_pages=len(self._lane_pages[lane])):
            pages = list(self._lane_pages[lane])
            invariant(self._scratch_page not in pages,
                      "scratch page leaked into a live block table",
                      lane=lane)
            s = self._sanitizer
            if s is not None:
                s.record("capture", lane=lane, pages=pages)
            idx = torch.tensor(pages, dtype=torch.long).to(self.device)
            kv = {key: self._to_wire(self.cache[key][:, idx])
                  for key in _POOL_KEY.values() if key in self.cache}
            ssm = {key: self._to_wire(self.cache[key][:, lane])
                   for key in ("ssm_h", "ssm_conv") if key in self.cache}
            ckpt = LaneCheckpoint(
                req=req, lane_seed=int(self._lane_seed[lane]),
                tok_idx=int(self._tok_idx[lane]),
                remaining=int(self._remaining_host[lane]),
                ctx_len=int(self._len_host[lane]),
                next_token=int(self._next_token[lane]),
                page_size=self.page_size, kv_pages=kv, ssm_state=ssm)
            # the evicted lane is dead: a dispatch before re-admission
            # samples only invalid tokens for it
            self._remaining[lane] = 0
            self._remaining_host[lane] = 0
            self._release_lane(lane)
            self.stats["preemptions"] += 1
        return ckpt

    @staticmethod
    def _to_wire(t: torch.Tensor) -> np.ndarray:
        """A host copy (never a view of the cache, which goes on
        changing) in the checkpoint's dtype."""
        wire = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        return t.to(device="cpu", dtype=wire, copy=True).numpy()

    def _from_wire(self, val: Any, like: torch.Tensor) -> torch.Tensor:
        arr = np.array(val, dtype=_WIRE_DTYPE[like.dtype])
        return torch.from_numpy(arr).to(self.device, like.dtype)

    def _check_payload(self, ckpt: LaneCheckpoint) -> None:
        """Raise unless every array of ``ckpt`` has the shape this engine
        holds it in (an indexed write would broadcast a smaller one)."""
        want = {key: (t.shape[0], ckpt.n_pages) + tuple(t.shape[2:])
                for key, t in self.cache.items() if key in _POOL_KEY.values()}
        want.update({key: tuple(self.cache[key][:, 0].shape)
                     for key in ("ssm_h", "ssm_conv") if key in self.cache})
        got = {key: tuple(np.shape(v)) for key, v in
               list(ckpt.kv_pages.items()) + list(ckpt.ssm_state.items())}
        invariant(got == want, "checkpoint payload does not fit this "
                  "engine's cache", got=got, want=want)

    def restore_pages(self, ckpt: LaneCheckpoint) -> int:
        """Pages :meth:`restore` reserves for ``ckpt``: its pages plus
        room for the remaining budget, clamped (as admission is) to what
        the cache can back."""
        worst = min(ckpt.ctx_len + ckpt.remaining + 1, self.max_len)
        return max(self._pages_needed(worst), ckpt.n_pages)

    def can_restore(self, ckpt: LaneCheckpoint) -> bool:
        if not self.free_lanes():
            return False
        return self.restore_pages(ckpt) <= self.pool.available()

    def restore(self, ckpt: LaneCheckpoint) -> bool:
        """Re-admit a checkpointed request through the reserve/alloc route
        and write its pages into fresh exclusive pages of its new block
        table.  Returns False when no lane or pages are free (retry after
        retirements, as with admission).

        A restore consumes no admission index: the lane takes the
        checkpoint's ``lane_seed``/``tok_idx``, so its random stream goes
        on, and its first step consumes the checkpoint's token.  Every
        write is in place (pools, state, next token, seed, index, budget,
        length), so the engine's graphs replay over the restored lane;
        its pages past the checkpoint's are mapped before the next
        dispatch (:meth:`map_dispatch_pages`)."""
        invariant(self.paged, "evict/restore: paged engines only")
        invariant(ckpt.page_size == self.page_size,
                  "checkpoint page size does not match this engine",
                  ckpt_page_size=ckpt.page_size, page_size=self.page_size)
        self._check_payload(ckpt)
        lanes = self.free_lanes()
        if not lanes:
            return False
        lane = lanes[0]
        need = self.restore_pages(ckpt)
        if not self.pool.reserve(need):
            if ckpt.uid not in self._blocked_uids:
                self._blocked_uids.add(ckpt.uid)
                self.stats["kv_admit_blocked"] += 1
            return False
        self._blocked_uids.discard(ckpt.uid)
        self._lane_reserved[lane] = need
        self._lane_pages[lane] = []
        restore_span = self.tracer.span(
            "preempt.restore", track=self.lane_track(lane),
            uid=ckpt.uid, n_pages=ckpt.n_pages)
        try:
            with restore_span:
                self._map_pages(lane, ckpt.n_pages)
                if self._lane_pages[lane]:
                    idx = torch.tensor(self._lane_pages[lane],
                                       dtype=torch.long).to(self.device)
                    for key, val in ckpt.kv_pages.items():
                        dst = self.cache[key]
                        dst[:, idx] = self._from_wire(val, dst)
                for key, val in ckpt.ssm_state.items():
                    dst = self.cache[key]
                    dst[:, lane] = self._from_wire(val, dst)
                s = self._sanitizer
                if s is not None and self._lane_pages[lane]:
                    s.record("write", lane=lane,
                             pages=list(self._lane_pages[lane]),
                             kind="restore")
        except Exception:
            # a payload that does not fit this engine's cache: the
            # reservation and the pages mapped so far go back, or they
            # would leak behind a lane that looks free
            self.pool.free(self._lane_pages[lane], holder=lane)
            self.pool.unreserve(self._lane_reserved[lane])
            self._lane_pages[lane] = []
            self._lane_reserved[lane] = 0
            self.cache["len"][lane] = 0
            if "block_tables" in self.cache:
                self.cache["block_tables"][lane] = self._scratch_page
            raise
        self.cache["len"][lane] = ckpt.ctx_len
        self._len_host[lane] = ckpt.ctx_len
        self._lane_seed[lane] = ckpt.lane_seed
        self._tok_idx[lane] = ckpt.tok_idx
        self._next_token[lane] = ckpt.next_token
        self._remaining[lane] = ckpt.remaining
        self._remaining_host[lane] = ckpt.remaining
        self.lane_req[lane] = ckpt.req
        self.stats["restores"] += 1
        self.stats["pages_migrated"] += ckpt.n_pages
        return True

    def decode_step(self) -> Dict[int, int]:
        """Single-token wrapper; returns {uid: token}."""
        return {uid: seq[0] for uid, seq in self.decode_n(1).items() if seq}

    def _never_admissible(self, head: Request) -> AdmissionRejected:
        """Terminal refusal: the head request was refused with NOTHING in
        flight, so no retirement can ever free a lane or a page."""
        self.stats["admit_rejected"] += 1
        return AdmissionRejected(
            uid=head.uid, reason="never_admissible", retry_after_s=None,
            need_pages=(self.admission_pages(head) if self.paged else None),
            pool_pages=(self.pool.n_pages if self.paged else None),
            n_lanes=self.n_lanes)

    def _shed_victim(self) -> Optional[int]:
        """Lane the degradation ladder evicts next: lowest request
        priority first, then the longest live context (most pages back);
        never the last live lane."""
        live = self.live_lanes()
        if len(live) < 2:
            return None
        return min(live, key=lambda i: (self.lane_req[i].priority,
                                        -self.lane_context(i), i))

    def run(self, requests: List[Request],
            dispatch_n: Optional[int] = None) -> List[Request]:
        """Serve a workload to completion with continuous admission.

        With a :class:`DegradationLadder` attached, sustained page
        pressure or repeated page-blocked admissions escalate load
        shedding: the dispatch size shrinks (each new size is a new CUDA
        graph on the card, counted by ``decode_compiles``), new
        admissions are deferred (backpressure), and at the top rung the
        lowest-priority lane is evicted to a checkpoint and restored once
        pressure clears.

        Raises :class:`AdmissionRejected` when the head request can never
        be admitted and nothing is in flight."""
        ladder = self.ladder
        pending = list(requests)
        shed: deque = deque()        # checkpoints the ladder evicted
        while pending or shed or self.live_lanes():
            # shed checkpoints re-enter first (their tokens are paid
            # for), but not while the ladder still sits at the evict
            # rung with live work, or restore and evict would thrash
            while shed and self.free_lanes():
                if ladder is not None and ladder.should_evict \
                        and self.live_lanes():
                    break
                if not self.restore(shed[0]):
                    break
                shed.popleft()
            while pending and self.free_lanes():
                if ladder is not None and ladder.refusing_admissions \
                        and (self.live_lanes() or shed):
                    # backpressure rung: finish in-flight work first
                    break
                if not self.admit(pending[0]):
                    # a lane is free but the pages are not: wait for
                    # retirements to refill the pool
                    if ladder is not None and self.paged:
                        ladder.note_admission_blocked(pending[0].uid)
                        self.stats["degrade_transitions"] = \
                            len(ladder.transitions)
                    break
                if ladder is not None:
                    ladder.note_ok()
                pending.pop(0)
            if not self.live_lanes():
                if shed:
                    # every live lane was shed and none could restore:
                    # the head checkpoint fit before, so it fits an
                    # empty engine
                    restored = self.restore(shed[0])
                    invariant(restored, "shed checkpoint no longer fits "
                              "an empty engine", uid=shed[0].uid)
                    shed.popleft()
                    continue
                raise self._never_admissible(pending[0])
            n = dispatch_n if dispatch_n is not None else self.dispatch_n
            if ladder is not None:
                n = ladder.dispatch_n(n)
            self.decode_n(n)
            if ladder is not None:
                if self.paged:
                    pool = self.pool
                    ladder.note_pressure(
                        (pool.n_pages - pool.available()) / pool.n_pages)
                else:
                    ladder.note_ok()
                self.stats["degrade_transitions"] = len(ladder.transitions)
                if ladder.should_evict and self.paged:
                    victim = self._shed_victim()
                    if victim is not None:
                        uid = self.lane_req[victim].uid
                        shed.append(self.evict(victim))
                        self.stats["degrade_sheds"] += 1
                        self.tracer.instant(
                            "degrade.shed", track=self.lane_track(victim),
                            uid=uid, level=ladder.level_name)
        return requests


#: the flat stats keys, in the schema's order
STATS_KEYS = tuple(ServeEngine.STATS_SCHEMA)
