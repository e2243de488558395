"""Page-lifecycle sanitizer: a shadow-state model of the paged KV pool.

A copy of the reference's ``analysis/sanitizer.py``.  The exactness
tests catch *symptoms* of allocator misuse (a corrupted
token stream); this module catches *causes*, at the op where they
happen.  A :class:`PageSanitizer` mirrors every allocator and lane
lifecycle operation against its own shadow copy of the
:class:`~repro_torch.serving.engine.PagePool` state and flags:

* ``DOUBLE_FREE`` -- a page freed more often than it was held;
* ``SCRATCH_PAGE`` -- the dead-lane scratch page allocated, shared,
  freed, written, or captured into a checkpoint (it is plumbing, not
  request state);
* ``ALIAS_EXCLUSIVE`` -- a lane maps a page into its block table
  without a recorded ``share``: two block tables would alias bytes the
  refcount believes are exclusively owned;
* ``WRITE_SHARED_NO_COW`` -- a holder that is not the page's original
  owner appends to a shared page without a preceding copy-on-write
  split (the donor itself MAY keep appending to its partial page: its
  writes land at slots beyond every consumer's matched length);
* ``ALLOC_UNRESERVED`` / ``RESERVE_UNDERFLOW`` -- reserve/alloc
  accounting imbalance (an alloc or cow not backed by an admission-time
  reservation, or an unreserve exceeding what was promised);
* ``SHARE_FREE`` / ``COW_EXCLUSIVE`` / ``UNKNOWN_PAGE`` -- refcount
  misuse (sharing a free page, cow of a sole-owner page, ops naming
  pages outside the pool);
* ``CONSERVATION`` -- the shadow state and the REAL pool disagree
  (:meth:`crosscheck`, run at every dispatch boundary when inline).

Two modes:

* **inline** -- ``ServeEngine(sanitize=True)`` attaches a sanitizer as
  ``pool.monitor``; every ``PagePool`` mutator forwards its op through
  one attribute check (``if self.monitor is not None``), which is the
  entire cost of the OFF mode.  Inline violations raise
  :class:`SanitizerError` at the faulting op.
* **offline** -- the same op stream is recorded as ``page.*`` events
  (:class:`repro_torch.obs.EventLog`); dump it with ``EventLog.dump`` and
  replay the ``pages.jsonl`` later with :meth:`PageSanitizer.replay`,
  which collects violations instead of raising.

Op schema (the ``pages.jsonl`` contract): every record carries ``op``
plus the fields listed in :data:`OP_FIELDS`.  Holder tags are opaque
(the engine uses lane indices, the prefix cache uses ``"cache"``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Set

from repro_torch.analysis.invariants import InvariantError

__all__ = ["PageSanitizer", "SanitizerError", "Violation", "VIOLATIONS",
           "load_jsonl"]


#: violation code -> meaning (the catalog the mutation tests pin)
VIOLATIONS = {
    "DOUBLE_FREE": "page freed more often than it was held",
    "SCRATCH_PAGE": "scratch page allocated/shared/freed/written/captured",
    "ALIAS_EXCLUSIVE": "lane maps a page it never allocated or shared",
    "WRITE_SHARED_NO_COW": "non-owner write to a shared page without CoW",
    "ALLOC_UNRESERVED": "alloc/cow not backed by a reservation",
    "RESERVE_UNDERFLOW": "unreserve exceeds the outstanding reservation",
    "SHARE_FREE": "share of a page that is not allocated",
    "COW_EXCLUSIVE": "copy-on-write split of a sole-owner page",
    "UNKNOWN_PAGE": "op names a page id outside the pool",
    "CONSERVATION": "shadow state disagrees with the real pool",
}

#: op name -> fields it carries (documentation + replay validation)
OP_FIELDS = {
    "init": ("n_pages", "page_size", "scratch"),
    "reserve": ("n", "ok"),
    "unreserve": ("n",),
    "alloc": ("pages", "holder"),
    "free": ("pages", "holder"),
    "share": ("pages", "holder"),
    "cow": ("old", "new", "holder"),
    "shrink": ("pages",),
    "grow": ("pages",),
    "map": ("lane", "pages"),
    "write": ("lane", "pages", "kind"),
    "capture": ("lane", "pages"),
}


class SanitizerError(InvariantError):
    """An inline (strict-mode) sanitizer violation."""

    def __init__(self, violation: "Violation"):
        super().__init__(f"[{violation.code}] {violation.message}",
                         **violation.op)
        self.violation = violation


@dataclasses.dataclass(frozen=True)
class Violation:
    """One detected lifecycle violation: code, detail, faulting op."""

    code: str
    message: str
    op: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "message": self.message, "op": self.op}


class PageSanitizer:
    """Shadow-state mirror of one PagePool + its lanes' block tables.

    Feed ops via :meth:`record` (the ``PagePool.monitor`` hook calls it
    for allocator ops; the engine calls it for map/write/capture).  In
    ``strict`` mode the first violation raises; otherwise violations
    accumulate in :attr:`violations` (the replay mode).
    """

    def __init__(self, strict: bool = True, log=None):
        self.strict = strict
        #: optional :class:`repro_torch.obs.EventLog`; every op is emitted as
        #: a ``page.<op>`` event for offline replay
        self.log = log
        self.violations: List[Violation] = []
        self.ops_seen = 0
        # shadow pool state
        self.n_pages = 0
        self.page_size = 0
        self.scratch: Optional[int] = None
        self._free: Set[int] = set()
        self._disabled: Set[int] = set()
        self._ref: Dict[int, int] = {}
        self._reserved = 0
        # lifecycle state: who allocated a page (its writer of record)
        # and who currently holds a reference on it
        self._owner: Dict[int, Any] = {}
        self._holders: Dict[int, Set[Any]] = {}

    # ------------------------------------------------------------------
    # violation plumbing
    # ------------------------------------------------------------------
    def _flag(self, code: str, message: str, op: Dict[str, Any]) -> None:
        v = Violation(code=code, message=message, op=dict(op))
        self.violations.append(v)
        if self.strict:
            raise SanitizerError(v)

    @property
    def clean(self) -> bool:
        return not self.violations

    # ------------------------------------------------------------------
    # op entry points
    # ------------------------------------------------------------------
    def record(self, op: str, **fields: Any) -> None:
        """Apply one lifecycle op to the shadow state and check it."""
        rec = {"op": op, **fields}
        self.ops_seen += 1
        if self.log is not None:
            self.log.emit(f"page.{op}", **fields)
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            self._flag("UNKNOWN_PAGE", f"unknown op {op!r}", rec)
            return
        handler(rec)

    # hook signature PagePool.monitor expects
    pool_op = record

    # ------------------------------------------------------------------
    # shadow transitions
    # ------------------------------------------------------------------
    def _op_init(self, rec) -> None:
        self.n_pages = int(rec["n_pages"])
        self.page_size = int(rec["page_size"])
        self.scratch = rec.get("scratch")
        self._free = set(range(self.n_pages))
        self._disabled = set()
        self._ref = {}
        self._owner = {}
        self._holders = {}
        self._reserved = 0

    def _known(self, page: int, rec) -> bool:
        if page == self.scratch:
            self._flag("SCRATCH_PAGE", VIOLATIONS["SCRATCH_PAGE"], rec)
            return False
        if not (0 <= int(page) < self.n_pages):
            self._flag("UNKNOWN_PAGE",
                       f"page {page} outside pool of {self.n_pages}", rec)
            return False
        return True

    def _op_reserve(self, rec) -> None:
        if rec.get("ok", True):
            self._reserved += int(rec["n"])
            if self._reserved > len(self._free):
                self._flag("ALLOC_UNRESERVED",
                           "reservation exceeds the free list", rec)

    def _op_unreserve(self, rec) -> None:
        n = int(rec["n"])
        if not 0 <= n <= self._reserved:
            self._flag("RESERVE_UNDERFLOW", VIOLATIONS["RESERVE_UNDERFLOW"],
                       rec)
            self._reserved = max(self._reserved - n, 0)
            return
        self._reserved -= n

    def _op_alloc(self, rec) -> None:
        pages = list(rec["pages"])
        holder = rec.get("holder")
        if len(pages) > self._reserved:
            self._flag("ALLOC_UNRESERVED", VIOLATIONS["ALLOC_UNRESERVED"],
                       rec)
        self._reserved = max(self._reserved - len(pages), 0)
        for p in pages:
            if not self._known(p, rec):
                continue
            if p not in self._free:
                self._flag("UNKNOWN_PAGE",
                           f"alloc of page {p} that is not free", rec)
                continue
            self._free.discard(p)
            self._ref[p] = 1
            self._owner[p] = holder
            self._holders[p] = {holder} if holder is not None else set()

    def _op_free(self, rec) -> None:
        holder = rec.get("holder")
        for p in list(rec["pages"]):
            if p == self.scratch:
                self._flag("SCRATCH_PAGE", VIOLATIONS["SCRATCH_PAGE"], rec)
                continue
            if p not in self._ref:
                self._flag("DOUBLE_FREE", f"free of page {p} with no "
                           "outstanding reference", rec)
                continue
            self._ref[p] -= 1
            if holder is not None:
                self._holders.get(p, set()).discard(holder)
            if self._ref[p] == 0:
                del self._ref[p]
                self._owner.pop(p, None)
                self._holders.pop(p, None)
                self._free.add(p)

    def _op_share(self, rec) -> None:
        holder = rec.get("holder")
        for p in list(rec["pages"]):
            if not self._known(p, rec):
                continue
            if p not in self._ref:
                self._flag("SHARE_FREE", f"share of free page {p}", rec)
                continue
            self._ref[p] += 1
            if holder is not None:
                self._holders.setdefault(p, set()).add(holder)

    def _op_cow(self, rec) -> None:
        old, new = rec["old"], rec["new"]
        holder = rec.get("holder")
        if self._known(old, rec):
            if self._ref.get(old, 0) < 2:
                self._flag("COW_EXCLUSIVE", VIOLATIONS["COW_EXCLUSIVE"],
                           rec)
            else:
                self._ref[old] -= 1
                if holder is not None:
                    self._holders.get(old, set()).discard(holder)
        if self._reserved < 1:
            self._flag("ALLOC_UNRESERVED", "cow without a reservation",
                       rec)
        else:
            self._reserved -= 1
        if self._known(new, rec):
            if new not in self._free:
                self._flag("UNKNOWN_PAGE",
                           f"cow target {new} is not free", rec)
            else:
                self._free.discard(new)
                self._ref[new] = 1
                self._owner[new] = holder
                self._holders[new] = ({holder} if holder is not None
                                      else set())

    def _op_shrink(self, rec) -> None:
        for p in list(rec["pages"]):
            if not self._known(p, rec):
                continue
            if p not in self._free:
                self._flag("UNKNOWN_PAGE",
                           f"shrink retired non-free page {p}", rec)
                continue
            self._free.discard(p)
            self._disabled.add(p)

    def _op_grow(self, rec) -> None:
        for p in list(rec["pages"]):
            if not self._known(p, rec):
                continue
            if p not in self._disabled:
                self._flag("UNKNOWN_PAGE",
                           f"grow returned non-disabled page {p}", rec)
                continue
            self._disabled.discard(p)
            self._free.add(p)

    def _op_map(self, rec) -> None:
        """A lane wrote page ids into its block-table row; each mapped
        page must carry the lane's reference (alloc'd by it or shared
        to it) -- otherwise two block tables alias exclusive bytes."""
        lane = rec["lane"]
        for p in list(rec["pages"]):
            if not self._known(p, rec):
                continue
            if lane not in self._holders.get(p, set()):
                self._flag("ALIAS_EXCLUSIVE",
                           f"lane {lane} maps page {p} without holding "
                           "a reference", rec)

    def _op_write(self, rec) -> None:
        """A holder appended KV into pages.  Writes to an exclusively
        owned page are always fine; writes to a SHARED page are legal
        only for its owner of record (the donor appending past every
        consumer's matched length) or as the copy half of a CoW split
        (``kind="cow_copy"`` targets the fresh exclusive page)."""
        lane = rec["lane"]
        for p in list(rec["pages"]):
            if p == self.scratch:
                self._flag("SCRATCH_PAGE",
                           f"write to the scratch page by lane {lane}",
                           rec)
                continue
            if p not in self._ref:
                self._flag("UNKNOWN_PAGE",
                           f"write to unallocated page {p}", rec)
                continue
            if lane not in self._holders.get(p, set()):
                self._flag("ALIAS_EXCLUSIVE",
                           f"lane {lane} writes page {p} without holding "
                           "a reference", rec)
                continue
            if self._ref[p] >= 2 and self._owner.get(p) != lane:
                self._flag("WRITE_SHARED_NO_COW",
                           f"lane {lane} writes shared page {p} owned by "
                           f"{self._owner.get(p)!r}", rec)

    def _op_capture(self, rec) -> None:
        """Evict gathered a lane's pages into a checkpoint; the scratch
        page must never travel (it is not request state)."""
        for p in list(rec["pages"]):
            if p == self.scratch:
                self._flag("SCRATCH_PAGE",
                           "scratch page captured into a checkpoint", rec)

    # ------------------------------------------------------------------
    # cross-checking and replay
    # ------------------------------------------------------------------
    def crosscheck(self, pool) -> None:
        """Compare the shadow against the REAL pool (dispatch-boundary
        hook): free set, refcounts, reservation, disabled count."""
        rec = {"op": "crosscheck"}
        if set(pool._free) != self._free:
            self._flag("CONSERVATION",
                       f"free set mismatch: pool={sorted(pool._free)} "
                       f"shadow={sorted(self._free)}", rec)
        if pool._refcount != self._ref:
            self._flag("CONSERVATION",
                       f"refcount mismatch: pool={pool._refcount} "
                       f"shadow={self._ref}", rec)
        if pool._reserved != self._reserved:
            self._flag("CONSERVATION",
                       f"reservation mismatch: pool={pool._reserved} "
                       f"shadow={self._reserved}", rec)
        if set(pool._disabled) != self._disabled:
            self._flag("CONSERVATION",
                       f"disabled mismatch: pool={sorted(pool._disabled)} "
                       f"shadow={sorted(self._disabled)}", rec)

    @classmethod
    def replay(cls, records: Iterable[Dict[str, Any]]) -> "PageSanitizer":
        """Offline mode: feed a recorded op stream (e.g. a loaded
        ``pages.jsonl``) through a non-strict sanitizer and return it
        with :attr:`violations` collected."""
        san = cls(strict=False)
        for rec in records:
            rec = dict(rec)
            name = rec.pop("op", None)
            if name is None:
                # EventLog records carry the op as "page.<op>"
                name = str(rec.pop("name", "")).split(".", 1)[-1]
            rec.pop("t", None)
            san.record(name, **rec)
        return san


def load_jsonl(path) -> List[Dict[str, Any]]:
    """Load a recorded ``pages.jsonl`` op stream (one op per line)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
