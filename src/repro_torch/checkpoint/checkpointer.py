"""Fault-tolerant checkpointing: atomic step directories, async writes,
resume-from-latest; the reference's ``checkpoint/checkpointer.py`` and
its on-disk layout, so a directory written by either package restores
in the other.

Layout:  <dir>/step_<N>/            (N as %08d)
             tree.json          -- {"step", "leaves": [{name, shape, dtype}]}
             shard_<i>.npz      -- leaf arrays ``a0``, ``a1``, ... (one shard)
             _COMPLETE          -- commit marker (atomicity)

The leaves are the reference's ``TrainState`` flattened: its names and
order and its stacked ``(L, ...)`` block shapes
(:mod:`repro_torch.checkpoint.layout`).  A bfloat16 leaf is
written as the reference writes it: its two bytes an element, which
``np.savez`` stores as ``|V2`` (the reference's ml_dtypes type does not
survive it), with ``"bfloat16"`` in ``tree.json``.  :func:`restore`
reads each leaf by the dtype ``tree.json`` names, so bf16 and int8
moments restore here (the reference's own ``restore`` cannot cast
``|V2`` back and raises).

Writes go to ``step_<N>.tmp`` and are renamed after the marker is
written, so a preemption mid-write never corrupts the latest
checkpoint.  ``AsyncCheckpointer`` moves serialization off the training
thread; ``restore_latest`` skips uncommitted directories.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.layout import (load_train_state,
                                           train_state_to_numpy)

#: a state brought to the host: (reference leaf name, array, dtype name)
HostLeaves = List[Tuple[str, np.ndarray, str]]


def _host(state) -> HostLeaves:
    return state if isinstance(state, list) else train_state_to_numpy(state)


def save(directory: str, step: int, state) -> str:
    """Synchronous atomic checkpoint write of a port ``TrainState`` (or
    its :func:`train_state_to_numpy` leaves). Returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    named = _host(state)
    meta = {"step": step,
            "leaves": [{"name": n, "shape": list(x.shape), "dtype": dt}
                       for n, x, dt in named]}
    arrays = {f"a{i}": (x.view("V2") if dt == "bfloat16" else x)
              for i, (_, x, dt) in enumerate(named)}
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _committed_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "_COMPLETE")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _read(directory: str, step: int) -> Dict[str, Tuple[np.ndarray, str]]:
    """A committed step's leaves: {name: (array as stored, dtype name)}."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        return {m["name"]: (data[f"a{i}"], m["dtype"])
                for i, m in enumerate(meta["leaves"])}


def restore(directory: str, step: int, state_like):
    """Restore into ``state_like`` (a port ``TrainState``, filled in place
    and returned; names and shapes checked, each leaf cast to the
    template's dtype)."""
    return load_train_state(state_like, _read(directory, step))


def restore_latest(directory: str, state_like):
    step = latest_step(directory)
    if step is None:
        return None, None
    return step, restore(directory, step, state_like)


def prune(directory: str, keep: int = 3) -> None:
    steps = _committed_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Serializes checkpoints on a background thread; at most one in
    flight (the training loop never blocks unless it laps the writer).
    ``save`` copies the state to the host before it returns, so the
    step that follows may update the state in place."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    def save(self, step: int, state) -> None:
        self.wait()
        host = train_state_to_numpy(state)          # device -> host copy

        def _write():
            save(self.directory, step, host)
            prune(self.directory, self.keep)

        self._pending = self._pool.submit(_write)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
