"""Bounded interleaving checker for the lane/page lifecycle.

A copy of the reference's ``analysis/interleave.py``, over the port's
:class:`PagePool` and :class:`PageSanitizer`.  Preemption churn
interleaves admit / prefix-hit admit /
copy-on-write / evict / restore / retire / cache-flush in orders no
single test scripts.  This module explores those orderings *bounded
exhaustively* against a REAL :class:`~repro_torch.serving.engine.PagePool`
mirrored by a non-strict :class:`~repro_torch.analysis.sanitizer.
PageSanitizer`: after every op the pool's own conservation invariants,
the shadow model, and a shadow-vs-pool crosscheck must all hold.

An order-dependent allocator bug (e.g. a free that ignores refcounts:
harmless until an interleaving shares the page first) surfaces as an
:class:`InterleavingBug` carrying the exact op trace that triggered it
-- a reproducer, not a flake.  :class:`RefcountBlindPool` is the
seeded bug double the detection tests drive through the explorer.

Not imported by ``repro_torch.analysis.__init__`` (it imports the engine;
the engine imports ``repro_torch.analysis.invariants``) -- import it
explicitly: ``from repro_torch.analysis import interleave``.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.analysis.invariants import InvariantError, invariant
from repro_torch.analysis.sanitizer import PageSanitizer
from repro_torch.serving.engine import PagePool

__all__ = ["LifecycleHarness", "InterleavingBug", "RefcountBlindPool",
           "explore"]

Op = Tuple[str, int]


class InterleavingBug(AssertionError):
    """An op ordering broke a lifecycle invariant.  ``trace`` is the
    exact op sequence -- a deterministic reproducer."""

    def __init__(self, trace: Tuple[Op, ...], cause: BaseException):
        self.trace = trace
        self.cause = cause
        pretty = " -> ".join(f"{name}({arg})" for name, arg in trace)
        super().__init__(f"interleaving bug after [{pretty}]: {cause!r}")


class _Lane:
    __slots__ = ("pages", "reserved")

    def __init__(self):
        self.pages: List[int] = []
        self.reserved = 0

    @property
    def live(self) -> bool:
        return bool(self.pages)


class LifecycleHarness:
    """A miniature engine lifecycle over a real PagePool.

    Each op mirrors the corresponding ``ServeEngine`` path (same
    reserve/alloc/share/cow/free sequencing, same monitor records) at
    page granularity, small enough to explore exhaustively:

    * ``admit``    -- reserve 3, alloc 2 prompt pages, prefill-write;
      the FIRST admit also donates its page 0 to the prefix cache
      (``share`` with holder ``"cache"``);
    * ``hit``      -- prefix-hit admit: share the cached page as block
      0, reserve 2, alloc 1 tail page, prefill-write the tail only;
    * ``cow``      -- copy-on-write split of a shared block 0 from the
      lane's reservation, then the divergent write;
    * ``decode``   -- append to the lane's LAST page (always exclusive
      or owned);
    * ``evict``    -- capture the lane's pages into a checkpoint, then
      free + unreserve (the engine's ``evict`` -> ``_release_lane``);
    * ``restore``  -- re-admit a checkpoint through reserve/alloc and
      a restore-write (the engine's ``restore``);
    * ``retire``   -- free + unreserve without a checkpoint;
    * ``flush``    -- the prefix cache drops its reference.
    """

    def __init__(self, n_lanes: int = 2, n_pages: int = 6,
                 page_size: int = 4,
                 pool_cls: Callable[..., PagePool] = PagePool):
        self.pool = pool_cls(n_pages, page_size)
        self.san = PageSanitizer(strict=False)
        self.pool.monitor = self.san
        self.san.record("init", n_pages=n_pages, page_size=page_size,
                        scratch=n_pages)
        self.lanes = [_Lane() for _ in range(n_lanes)]
        self.cache_page: Optional[int] = None
        self.ckpts: List[int] = []       # page counts of evicted lanes

    # ------------------------------------------------------------------
    # op enumeration (sorted: exploration order is deterministic)
    # ------------------------------------------------------------------
    def available_ops(self) -> List[Op]:
        ops: List[Op] = []
        for i, lane in enumerate(self.lanes):
            if not lane.live:
                if self.pool.available() >= 3:
                    ops.append(("admit", i))
                if self.cache_page is not None \
                        and self.pool.available() >= 2:
                    ops.append(("hit", i))
                if self.ckpts and \
                        self.pool.available() >= self.ckpts[0] + 1:
                    ops.append(("restore", i))
            else:
                ops.append(("decode", i))
                ops.append(("evict", i))
                ops.append(("retire", i))
                if lane.reserved >= 1 and \
                        self.pool.is_shared(lane.pages[0]):
                    ops.append(("cow", i))
        if self.cache_page is not None:
            ops.append(("flush", 0))
        return sorted(ops)

    def apply(self, op: Op) -> None:
        name, lane = op
        getattr(self, f"_do_{name}")(lane)

    # ------------------------------------------------------------------
    # ops (each mirrors the engine's sequencing)
    # ------------------------------------------------------------------
    def _do_admit(self, i: int) -> None:
        lane = self.lanes[i]
        invariant(self.pool.reserve(3), "admit reserve failed", lane=i)
        lane.reserved = 3
        pages = self.pool.alloc(2, holder=i)
        lane.reserved -= 2
        lane.pages = list(pages)
        self.san.record("map", lane=i, pages=list(pages))
        self.san.record("write", lane=i, pages=list(pages),
                        kind="prefill")
        if self.cache_page is None:
            # the radix cache takes its own reference on the prompt page
            self.pool.share([pages[0]], holder="cache")
            self.cache_page = pages[0]

    def _do_hit(self, i: int) -> None:
        lane = self.lanes[i]
        invariant(self.pool.reserve(2), "hit reserve failed", lane=i)
        lane.reserved = 2
        self.pool.share([self.cache_page], holder=i)
        lane.pages = [self.cache_page]
        self.san.record("map", lane=i, pages=[self.cache_page])
        tail = self.pool.alloc(1, holder=i)
        lane.reserved -= 1
        lane.pages.extend(tail)
        self.san.record("map", lane=i, pages=list(tail))
        self.san.record("write", lane=i, pages=list(tail),
                        kind="prefill")

    def _do_cow(self, i: int) -> None:
        lane = self.lanes[i]
        old = lane.pages[0]
        new = self.pool.cow(old, holder=i)
        lane.reserved -= 1
        lane.pages[0] = new
        self.san.record("write", lane=i, pages=[new], kind="cow_copy")

    def _do_decode(self, i: int) -> None:
        lane = self.lanes[i]
        self.san.record("write", lane=i, pages=[lane.pages[-1]],
                        kind="decode")

    def _do_evict(self, i: int) -> None:
        lane = self.lanes[i]
        self.san.record("capture", lane=i, pages=list(lane.pages))
        self.ckpts.append(len(lane.pages))
        self._release(i)

    def _do_retire(self, i: int) -> None:
        self._release(i)

    def _release(self, i: int) -> None:
        lane = self.lanes[i]
        self.pool.free(lane.pages, holder=i)
        self.pool.unreserve(lane.reserved)
        lane.pages = []
        lane.reserved = 0

    def _do_restore(self, i: int) -> None:
        lane = self.lanes[i]
        n = self.ckpts.pop(0)
        invariant(self.pool.reserve(n + 1), "restore reserve failed",
                  lane=i)
        lane.reserved = n + 1
        pages = self.pool.alloc(n, holder=i)
        lane.reserved -= n
        lane.pages = list(pages)
        self.san.record("map", lane=i, pages=list(pages))
        self.san.record("write", lane=i, pages=list(pages),
                        kind="restore")

    def _do_flush(self, _: int) -> None:
        self.pool.free([self.cache_page], holder="cache")
        self.cache_page = None

    # ------------------------------------------------------------------
    # verification (after every op)
    # ------------------------------------------------------------------
    def verify(self) -> None:
        self.pool.check()
        self.san.crosscheck(self.pool)
        if self.san.violations:
            raise InvariantError(
                "sanitizer violations",
                codes=[v.code for v in self.san.violations],
                detail=[v.message for v in self.san.violations])

    def apply_indices(self, indices) -> int:
        """Drive the harness by choice indices (the Hypothesis entry
        point): each index picks from the current legal-op list.
        Verifies after every op; returns the number of ops applied."""
        applied = 0
        for idx in indices:
            ops = self.available_ops()
            if not ops:
                break
            self.apply(ops[idx % len(ops)])
            self.verify()
            applied += 1
        return applied


def explore(factory: Callable[[], LifecycleHarness],
            depth: int = 4) -> int:
    """Exhaustively explore every legal op interleaving to ``depth``.

    Every reached state is verified (pool invariants + shadow model +
    crosscheck).  Raises :class:`InterleavingBug` with the exact op
    trace on the first violation; returns the number of states visited
    on a clean sweep.
    """
    visited = 0
    stack: List[Tuple[LifecycleHarness, Tuple[Op, ...]]] = \
        [(factory(), ())]
    while stack:
        h, trace = stack.pop()
        visited += 1
        if len(trace) >= depth:
            continue
        for op in h.available_ops():
            h2 = copy.deepcopy(h)
            try:
                h2.apply(op)
                h2.verify()
            except InterleavingBug:
                raise
            except BaseException as e:
                raise InterleavingBug(trace + (op,), e) from e
            stack.append((h2, trace + (op,)))
    return visited


class RefcountBlindPool(PagePool):
    """Seeded bug double: ``free`` physically frees the page no matter
    how many holders remain (the classic pre-refcount allocator).  In
    share-free interleavings it is indistinguishable from the real
    pool; once an interleaving shares a page (prefix-cache donation)
    and one holder releases, the page is re-issued while the other
    holder still maps it -- which is exactly what :func:`explore` must
    catch (detection pinned by the analysis tests)."""

    def free(self, pages: List[int], holder: Any = None) -> None:
        for p in pages:
            invariant(p in self._in_use, f"double free of page {p}")
            del self._refcount[p]
            self._in_use.remove(p)
            self._free.append(p)
            self.free_count += 1
        m = self.monitor
        if m is not None:
            m.record("free", pages=list(pages), holder=holder)
