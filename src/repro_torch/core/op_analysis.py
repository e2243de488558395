"""Op analysis of one step: FLOPs, bytes, peak live bytes, collectives
and an op census, from the aten ops the step dispatches.

The counterpart of the reference's ``core/hlo_analysis.py``.  The
reference reads a compiled XLA program's HLO text: collective bytes
from its all-gather / all-reduce / ... instructions, an instruction
census, layout-churn ops.  The port compiles no program -- PyTorch runs
op by op -- so the input here is the stream of aten ops a step
dispatches, seen by a ``TorchDispatchMode`` (:class:`OpAnalysis`) while
the step runs, typically on the ``meta`` device, where tensors have
shapes and no data and the step allocates nothing:

* FLOPs by ``torch.utils.flop_counter``'s table (the formulas
  ``FlopCounterMode`` applies: matmuls, convolutions, attention; every
  execution counted, backward included);
* bytes: each op's input and output bytes (the unfused upper bound);
* peak live bytes: every storage an op creates is live from its
  creation until its last reference dies (a weak reference's
  finalizer), on top of the storages the caller declares live
  (:meth:`OpAnalysis.hold`: the step's arguments); a storage that
  existed before and was not declared stays out, also when an op
  writes into it;
* collectives: the ``c10d`` / ``_c10d_functional`` ops, by kind, with
  their output bytes (none on one device);
* the census by op name and the dtype round trips
  (:func:`count_convert_pairs`).

:func:`repeated` marks a region that stands for ``n`` identical
executions (shape-only code that would repeat the same shapes): its
FLOPs, bytes, collectives and census count ``n`` times, its liveness
once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["CollectiveStats", "OpAnalysis", "count_convert_pairs",
           "op_census", "repeated"]

_rep = threading.local()

#: namespaces of the collective ops (``torch.distributed``'s)
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")

_CANON = {
    "all_gather": "all-gather", "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
    "collective_permute": "collective-permute",
}


@contextlib.contextmanager
def repeated(n: int):
    """Count what runs inside as ``n`` executions (nests by product)."""
    prev = getattr(_rep, "n", 1)
    _rep.n = prev * int(n)
    try:
        yield
    finally:
        _rep.n = prev


def _times() -> int:
    return getattr(_rep, "n", 1)


@dataclasses.dataclass
class CollectiveStats:
    """Per-kind collective byte counts for one step."""

    bytes_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    count_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        kind = _CANON.get(kind, kind)
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def summary(self) -> str:
        parts = [f"{k}: n={self.count_by_kind[k]} "
                 f"bytes={self.bytes_by_kind[k]:,}"
                 for k in sorted(self.bytes_by_kind)]
        return "; ".join(parts) if parts else "no collectives"


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> str:
    """The collective ``func`` performs (``all_reduce``, ...), or ``""``."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return ""
    name = func._schema.name.split("::")[-1].rstrip("_")
    for kind in _CANON:
        if name.startswith(kind):
            return kind
    return name


class OpAnalysis(TorchDispatchMode):
    """Counts the ops dispatched while it is active (see the module
    docstring).  ``flops``, ``bytes``, ``peak_bytes``, ``live_bytes``,
    ``collectives``, ``census`` (op name -> count) and ``convert_pairs``
    hold the results."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.census: Dict[str, int] = {}
        self.collectives = CollectiveStats()
        self.convert_pairs = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        #: storage id -> dtype it was converted from by ``_to_copy``
        self._converted: Dict[int, torch.dtype] = {}

    # -- liveness ------------------------------------------------------
    def _forget(self, key: int, nbytes: int) -> None:
        self.live_bytes -= nbytes
        del self._live[key]
        self._converted.pop(key, None)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        weakref.finalize(st, self._forget, key, n)

    def hold(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count ``tensors``' storages as live from now on (the step's
        arguments: state, batch, cache)."""
        for t in tensors:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        n = _times()
        packet = func._overloadpacket
        name = str(packet).split(".", 1)[-1] if "." in str(packet) \
            else str(packet)
        self.census[name] = self.census.get(name, 0) + n
        if packet in flop_registry:
            self.flops += n * int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.bytes += n * (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        kind = _collective_kind(func)
        if kind:
            for _ in range(n):
                self.collectives.add(kind, sum(_nbytes(t) for t in outs))
        if packet is torch.ops.aten._to_copy and ins and outs:
            src, dst = ins[0], outs[0]
            if src.dtype != dst.dtype:
                back = self._converted.get(id(src.untyped_storage()))
                if back is not None and back == dst.dtype:
                    self.convert_pairs += n
        # an output on one of the inputs' storages (a view, an in-place
        # op) is either counted already or was left out by the caller
        mine = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            if id(t.untyped_storage()) not in mine:
                self._track(t)
        if packet is torch.ops.aten._to_copy and ins and outs and \
                ins[0].dtype != outs[0].dtype:
            self._converted[id(outs[0].untyped_storage())] = ins[0].dtype
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


def op_census(analysis: OpAnalysis) -> Dict[str, int]:
    """Op-count histogram by aten op name (spotting remat-duplicated
    work: a recomputed block's ops appear twice)."""
    return dict(sorted(analysis.census.items()))


def count_convert_pairs(analysis: OpAnalysis) -> int:
    """Dtype round trips: a ``_to_copy`` to a dtype whose input was
    itself converted from that dtype (say bf16 -> f32 -> bf16)."""
    return analysis.convert_pairs

