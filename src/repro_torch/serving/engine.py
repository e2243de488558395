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
  the lane's row or pages;
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

Prefix sharing, evict/restore and the telemetry hooks come in later
slices.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import rng as trng
from repro_torch.analysis.invariants import invariant
from repro_torch.device import resolve_device
from repro_torch.models.attention import quantize_kv_token
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import paged_capacity, sample_tokens
from repro_torch.serving.cuda_graphs import StepGraphs
from repro_torch.serving.resilience import AdmissionRejected

__all__ = ["PagePool", "Request", "ServeEngine", "STATS_KEYS"]


# ----------------------------------------------------------------------
# page-pool allocator
# ----------------------------------------------------------------------

class PagePool:
    """Host-side free-list allocator over the global KV page pool.

    Invariants: ``n_free + n_in_use == n_pages``; pages move between two
    disjoint sets (no double alloc, no double free); ``reserve(n)``
    promises ``n`` future ``alloc`` pages and ``available()`` (what
    admission gates on) never counts promised pages, so mid-generation
    growth cannot fail.  The free list is LIFO, as in the reference, so
    both hand out the same page ids for the same call sequence.
    """

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._in_use: set = set()
        self._reserved = 0
        self.hwm = 0                 # high-water mark: in-use + reserved

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return len(self._in_use)

    def available(self) -> int:
        """Pages admissible to NEW requests (free minus promised)."""
        return len(self._free) - self._reserved

    def reserve(self, n: int) -> bool:
        """Promise ``n`` pages to a request; False if over-committed."""
        ok = n <= self.available()
        if ok:
            self._reserved += n
            self.hwm = max(self.hwm, self.n_in_use + self._reserved)
        return ok

    def unreserve(self, n: int) -> None:
        invariant(0 <= n <= self._reserved,
                  "unreserve exceeds reservation",
                  n=n, reserved=self._reserved)
        self._reserved -= n

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` previously reserved pages off the free list."""
        invariant(n <= self._reserved, "alloc without reservation",
                  n=n, reserved=self._reserved)
        invariant(n <= len(self._free), "free list underflow",
                  n=n, n_free=len(self._free))
        self._reserved -= n
        pages = [self._free.pop() for _ in range(n)]
        self._in_use.update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            invariant(p in self._in_use, f"double free of page {p}",
                      page=p)
            self._in_use.remove(p)
            self._free.append(p)

    def check(self) -> None:
        """Raise unless the conservation invariants hold (test hook)."""
        invariant(len(self._free) + len(self._in_use) == self.n_pages,
                  "page conservation broken", n_free=len(self._free),
                  n_in_use=len(self._in_use), n_pages=self.n_pages)
        invariant(len(set(self._free)) == len(self._free),
                  "duplicate page on the free list")
        invariant(not self._in_use.intersection(self._free),
                  "page both in use and free")
        invariant(0 <= self._reserved <= len(self._free),
                  "reservation exceeds the free list",
                  reserved=self._reserved, n_free=len(self._free))


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


def _bucket_len(n: int, floor: int = 8) -> int:
    """Smallest power-of-two >= n (>= floor) -- the prefill shape bucket."""
    b = floor
    while b < n:
        b <<= 1
    return b


#: paged pool holding each dense cache entry
_POOL_KEY = {"k": "k_pages", "v": "v_pages", "k_scale": "k_scale_pages",
             "v_scale": "v_scale_pages"}

#: the reference's STATS_SCHEMA keys this slice moves
STATS_KEYS = ("decode_dispatches", "decode_steps", "decode_compiles",
              "generated_tokens", "prefill_compiles", "ssm_prefill_compiles",
              "kv_pages_hwm", "kv_admit_blocked", "admit_rejected")


class ServeEngine:
    """Continuous batcher around a decoder (dense, ssm or hybrid).

    ``n_lanes`` bounds the decode batch width; with ``paged=True``,
    ``n_pages`` bounds KV bytes (default: ``n_lanes`` full contexts).
    ``dispatch_n`` is the number of tokens each lane advances per
    dispatch.  ``temperature`` > 0 samples, keyed from ``rng_seed``;
    ``prefill_bucketing=False`` prefills each prompt at its own length.
    ``stats`` holds the counters named in :data:`STATS_KEYS`;
    ``prefill_compiles`` counts distinct prefill shapes (the reference
    compiles once per shape), ``decode_compiles`` the distinct dispatch
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
    cost throughput.  A capture's own seconds stay out of those and go
    to ``timings["capture"]``, by graph (``n_steps``, or ``"ssm_step"``
    for the stream's step), whether timed or not.
    """

    def __init__(self, cfg: ModelConfig, params, n_lanes: int = 4,
                 max_len: int = 512, temperature: float = 0.0,
                 rng_seed: int = 0, dispatch_n: int = 8,
                 prefill_bucketing: bool = True, paged: bool = False,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 device=None, timed: bool = False):
        self.device = resolve_device(device)
        param_dev = next(params.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"params on {param_dev}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = params
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.temperature = float(temperature)
        self.dispatch_n = max(1, dispatch_n)
        self.prefill_bucketing = prefill_bucketing
        self.paged = bool(paged)
        self.page_size = int(page_size)
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
        if cfg.has_ssm:
            # the prompt stream's batch-1 cache and input token, at
            # addresses a captured decode step replays: the shared page
            # pools themselves, a batch-1 row of everything per lane
            self._ssm_lane = {}
            for key, t in self.cache.items():
                if key in _POOL_KEY.values():
                    self._ssm_lane[key] = t
                elif key in ("len", "block_tables"):
                    self._ssm_lane[key] = torch.zeros_like(t[:1])
                else:
                    self._ssm_lane[key] = torch.zeros_like(t[:, :1])
            self._ssm_tok = torch.zeros(1, dtype=torch.int32, device=dev)
        self.graphs = StepGraphs(dev)
        self.stats: Dict[str, int] = {k: 0 for k in STATS_KEYS}
        self.timed = timed
        self.timings: Dict[str, Any] = {"prefill": defaultdict(list),
                                        "decode": [], "decode_replayed": [],
                                        "ssm_stream": [],
                                        "capture": self.graphs.capture_s}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        if self.paged:
            need = self.admission_pages(req)
            if not self.pool.reserve(need):
                # a lane is free but the KV bytes are not; counted once
                # per blocked episode, not per retry
                if req.uid not in self._blocked_uids:
                    self._blocked_uids.add(req.uid)
                    self.stats["kv_admit_blocked"] += 1
                return False
            self._blocked_uids.discard(req.uid)
            self._lane_reserved[lane] = need
            self._lane_pages[lane] = []
            # map the prompt's pages plus the first decode write slot;
            # generation growth maps the rest at dispatch boundaries
            self._map_pages(lane,
                            self._pages_needed(self._trunc_plen(req) + 1))
        self._lane_seed[lane] = self._admit_count
        self._tok_idx[lane] = 0
        self._prefill_into_lane(req, lane)
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
        new = self.pool.alloc(target - have)
        self._lane_reserved[lane] -= len(new)
        self._lane_pages[lane].extend(new)
        self.cache["block_tables"][lane, have:target] = torch.tensor(
            new, dtype=torch.int32).to(self.device)
        self.stats["kv_pages_hwm"] = max(self.stats["kv_pages_hwm"],
                                         self.pool.hwm)

    # -- prefill ----------------------------------------------------------
    def _prefill_into_lane(self, req: Request, lane: int) -> None:
        prompt = self._trunc_prompt(req)
        plen = int(prompt.shape[0])
        self._len_host[lane] = plen
        bucket = _bucket_len(plen) if self.prefill_bucketing else plen
        if bucket not in self._buckets:
            self._buckets.add(bucket)
            self.stats["prefill_compiles"] = len(self._buckets)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = prompt
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        logits, kv = self.model.prefill(
            self.params, torch.from_numpy(padded).to(self.device),
            last_pos=torch.tensor([plen - 1], device=self.device))
        if kv is not None:
            if self.paged:
                self._scatter_prompt_paged(kv, lane, plen)
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
            self.timings["prefill"][bucket].append(time.perf_counter() - t0)

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

    def _scatter_prompt_paged(self, kv, lane: int, plen: int) -> None:
        """Write the prompt KV (and its scales when int8) into the lane's
        mapped pages, in one indexed copy per pool."""
        ps = self.page_size
        entries, take = self._prompt_kv_views(kv, plen, ps * self._bt_width)
        n_pg = -(-take // ps)
        pad = n_pg * ps - take
        pages = torch.tensor(self._lane_pages[lane][:n_pg],
                             dtype=torch.long).to(self.device)
        for key, src in entries.items():
            pool = self.cache[_POOL_KEY[key]]
            if pad:
                src = torch.nn.functional.pad(src, (0, 0, 0, pad))
            n_l, hkv, _, d = src.shape
            seg = src.reshape(n_l, hkv, n_pg, ps, d).permute(0, 2, 1, 3, 4)
            pool[:, pages] = seg.to(pool.dtype)

    def _ssm_step(self) -> torch.Tensor:
        """One batch-1 decode step of the prompt stream over its own
        buffers: the token in ``_ssm_tok`` advances ``_ssm_lane``'s state
        and K/V (in place) and length; returns the logits."""
        logits, cache = self.model.decode_step(self.params, self._ssm_lane,
                                               self._ssm_tok)
        self._ssm_lane["len"].copy_(cache["len"])
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
            t0 = time.perf_counter()
        captured = "ssm_step" in self.graphs.capture_s
        buf = self._ssm_lane
        # the stream starts from zero state: a re-admitted lane must NOT
        # inherit the previous request's
        for key in ("ssm_h", "ssm_conv", "len"):
            buf[key].zero_()
        if "block_tables" in buf:
            buf["block_tables"].copy_(self.cache["block_tables"][lane:lane + 1])
        toks = torch.from_numpy(prompt.astype(np.int32)).to(self.device)
        for t in range(plen):
            self._ssm_tok.copy_(toks[t:t + 1])
            logits, _ = self.graphs.run("ssm_step", self._ssm_step)
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
        if self.timed:
            self._sync()
            capture = (0.0 if captured else
                       self.graphs.capture_s.get("ssm_step", 0.0))
            self.timings["ssm_stream"].append(time.perf_counter() - t0
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
        self.map_dispatch_pages(n)
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        block, first = self.graphs.run(n, lambda: self._decode_block(n))
        if first:
            self.stats["decode_compiles"] += 1
        self.stats["decode_dispatches"] += 1
        self.stats["decode_steps"] += n
        # one host transfer drains the whole block
        block = block.cpu().numpy()
        if self.timed:
            capture = self.graphs.capture_s.get(n, 0.0) if first else 0.0
            self.timings["decode"].append(time.perf_counter() - t0 - capture)
            self.timings["decode_replayed"].append(self.graphs.on_card
                                                   and not first)
        toks_h = block[:n]
        valid_h = block[n:2 * n].astype(bool)
        self._remaining_host = block[2 * n].astype(np.int64)
        out: Dict[int, List[int]] = {}
        for lane in live:
            req = self.lane_req[lane]
            seq = [int(t) for t in toks_h[valid_h[:, lane], lane]]
            req.generated.extend(seq)
            out[req.uid] = seq
            self.stats["generated_tokens"] += len(seq)
            # the device length advanced once per valid sample
            self._len_host[lane] += len(seq)
            if self._remaining_host[lane] <= 0:
                req.done = True
                self._release_lane(lane)
        return out

    def _release_lane(self, lane: int) -> None:
        """Return a lane to the DEAD state: zero its length (so the
        length-aware kernel reads nothing of the stale context); when
        paged, drop its pages and reservation and point its block-table
        row at the scratch page (its old page ids may be re-issued while
        the dead lane keeps stepping)."""
        self.lane_req[lane] = None
        self.cache["len"][lane] = 0
        self._len_host[lane] = 0
        if self.paged:
            self.pool.free(self._lane_pages[lane])
            self.pool.unreserve(self._lane_reserved[lane])
            self._lane_pages[lane] = []
            self._lane_reserved[lane] = 0
            if "block_tables" in self.cache:
                self.cache["block_tables"][lane] = self._scratch_page

    def lane_pages(self, lane: int) -> List[int]:
        """Page ids mapped by ``lane``'s block table, in logical order."""
        return list(self._lane_pages[lane])

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

    def run(self, requests: List[Request],
            dispatch_n: Optional[int] = None) -> List[Request]:
        """Serve a workload to completion with continuous admission.

        Raises :class:`AdmissionRejected` when the head request can never
        be admitted and nothing is in flight."""
        pending = list(requests)
        while pending or self.live_lanes():
            while pending and self.free_lanes():
                if not self.admit(pending[0]):
                    break           # wait for retirements to free pages
                pending.pop(0)
            if not self.live_lanes():
                raise self._never_admissible(pending[0])
            self.decode_n(dispatch_n if dispatch_n is not None
                          else self.dispatch_n)
        return requests
