"""Hand-written Hopper kernels of the port, each beside its plain version.

``launch_counts()`` / ``reset_launch_counts()`` read and zero the
wrappers' launch counters, so a run can show which kernels its main
path went through.  A wrapper counts where its Python code launches, so
under a CUDA graph it counts only while the graph is captured: the
capturer takes the capture's :func:`launch_delta` back out and adds it
once per replay (:func:`add_launches`), and the counts stay launches
executed, eager or replayed.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention import ops as _decode_ops
from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.fma_matmul import ops as _matmul_ops
from repro_torch.kernels.mixbench import ops as _mixbench_ops
from repro_torch.kernels.qmatmul import ops as _qmatmul_ops
from repro_torch.kernels.ssd_scan import ops as _ssd_ops

__all__ = ["COUNTERS", "add_launches", "launch_counts", "launch_delta",
           "reset_launch_counts"]

COUNTERS = {c.name: c for c in (_decode_ops.COUNTER,
                                _decode_ops.COUNTER_LENGTHAWARE,
                                _decode_ops.COUNTER_MASKED,
                                _decode_ops.COUNTER_PAGED_Q8,
                                _decode_ops.COUNTER_Q8_LENGTHAWARE,
                                _decode_ops.COUNTER_Q8_MASKED,
                                _flash_ops.COUNTER_MMA,
                                _flash_ops.COUNTER_CC,
                                _mixbench_ops.COUNTER_FMA,
                                _mixbench_ops.COUNTER_MUL_ADD,
                                _matmul_ops.COUNTER_MXU,
                                _matmul_ops.COUNTER_MXU_WMMA,
                                _matmul_ops.COUNTER_MUL_ADD,
                                _matmul_ops.COUNTER_MUL_ADD_STAGED,
                                _qmatmul_ops.COUNTER_DEQUANT_DOT,
                                _qmatmul_ops.COUNTER_DOT_I8,
                                _ssd_ops.COUNTER)}


def launch_counts() -> Dict[str, int]:
    return {name: c.n for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def launch_delta(before: Dict[str, int], after: Dict[str, int]
                 ) -> Dict[str, int]:
    """The counters that moved from ``before`` to ``after`` (two
    :func:`launch_counts` readings), by how much."""
    return {name: after[name] - before[name] for name in sorted(after)
            if after[name] != before[name]}


def add_launches(delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters: a graph's replays
    (``times`` > 0), or a capture taken back out (``times=-1``)."""
    for name in sorted(delta):
        COUNTERS[name].n += times * delta[name]
