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
``|V2`` back and raises).  A leaf is read when :func:`restore` asks for
it (:class:`_Shard`), straight from its offset in the ``.npz`` into its
array, its CRC-32 checked as ``np.load`` checks it.

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
import zipfile
import zlib
from typing import Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint.layout import (load_train_state,
                                           train_state_to_numpy)
from repro_torch.parallel import runtime, sharding

#: a state brought to the host: (reference leaf name, array, dtype name)
HostLeaves = List[Tuple[str, np.ndarray, str]]


def _host(state) -> HostLeaves:
    return state if isinstance(state, list) else train_state_to_numpy(state)


def save(directory: str, step: int, state) -> str:
    """Synchronous atomic checkpoint write of a port ``TrainState`` (or
    its :func:`train_state_to_numpy` leaves). Returns the final path.

    In a process group rank 0 alone writes.  A state placed on the
    active mesh is gathered first (every rank calls ``save``), and every
    rank returns once the step is committed."""
    final = os.path.join(directory, f"step_{step:08d}")
    named = _host(state)
    if runtime.rank() == 0:
        _write(final, step, named)
    if sharding.active() is not None and not isinstance(state, list):
        dist.barrier()
    return final


def _write(final: str, step: int, named: HostLeaves) -> None:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
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


#: leaves a restore reads ahead of the one it copies (at most this many
#: arrays on the host besides it)
READ_AHEAD = 4


class _Shard(Mapping):
    """A committed step's leaves, each read when it is asked for:
    ``{name: (array as stored, dtype name)}``.

    ``np.savez`` stores every array uncompressed, a ``.npy`` member of
    the zip; such a member is read from its offset into its array in one
    ``np.fromfile`` and its CRC-32 checked after, where ``np.load``
    copies it through the zip reader a quarter-MiB at a time.  A
    compressed member is read through the zip reader.  Within ``with``,
    asking for a leaf also starts reading the :data:`READ_AHEAD` leaves
    after it in the file's order on worker threads (the file read and
    the CRC release the GIL): a restore asks for them in that order, so
    it reads while it copies the earlier ones to the card."""

    def __init__(self, path: str, meta: dict):
        self._path = path
        self._leaves = {m["name"]: (f"a{i}.npy", m["dtype"])
                        for i, m in enumerate(meta["leaves"])}
        self._next = dict(zip(self._leaves, list(self._leaves)[1:]))
        with zipfile.ZipFile(path) as z:
            self._infos = {i.filename: i for i in z.infolist()}
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: dict = {}

    def __enter__(self) -> "_Shard":
        self._pool = concurrent.futures.ThreadPoolExecutor(READ_AHEAD)
        return self

    def __exit__(self, *exc) -> None:
        if self._pool is not None:
            for fut in self._pending.values():
                fut.cancel()
            self._pool.shutdown(wait=True)
            self._pool, self._pending = None, {}

    def __iter__(self) -> Iterator[str]:
        return iter(self._leaves)

    def __len__(self) -> int:
        return len(self._leaves)

    def __getitem__(self, name: str) -> Tuple[np.ndarray, str]:
        fut = self._pending.pop(name, None)
        if self._pool is not None:
            nxt = name
            for _ in range(READ_AHEAD):
                nxt = self._next.get(nxt)
                if nxt is None:
                    break
                if nxt not in self._pending:
                    self._pending[nxt] = self._pool.submit(self._load, nxt)
        return fut.result() if fut is not None else self._load(name)

    def _load(self, name: str) -> Tuple[np.ndarray, str]:
        member, dtype_name = self._leaves[name]
        info = self._infos[member]
        if info.compress_type != zipfile.ZIP_STORED:
            with zipfile.ZipFile(self._path) as z, z.open(info) as f:
                return np.lib.format.read_array(f), dtype_name
        with open(self._path, "rb") as f:
            return _stored_array(f, info, name), dtype_name


def _stored_array(f, info: zipfile.ZipInfo, name: str) -> np.ndarray:
    """The ``.npy`` array of the uncompressed zip member ``info`` of the
    open file ``f``; raises when its bytes do not match the zip's size
    or CRC-32."""
    f.seek(info.header_offset)
    local = f.read(30)                 # the member's local file header
    start = info.header_offset + 30 + int.from_bytes(local[26:28], "little") \
        + int.from_bytes(local[28:30], "little")
    f.seek(start)
    version = np.lib.format.read_magic(f)
    shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                             if version == (1, 0) else
                             np.lib.format.read_array_header_2_0(f))
    head = f.tell() - start
    count = int(np.prod(shape))
    if dtype.hasobject or head + count * dtype.itemsize != info.file_size:
        raise ValueError(f"checkpoint leaf {name}: member {info.filename} "
                         f"is not a plain array of {shape} {dtype}")
    f.seek(start)
    crc = zlib.crc32(f.read(head))
    arr = np.fromfile(f, dtype=dtype, count=count)
    if zlib.crc32(arr.view(np.uint8), crc) != info.CRC:
        raise ValueError(f"checkpoint leaf {name}: bad CRC-32 in "
                         f"{info.filename}")
    return arr.reshape(shape, order="F" if fortran else "C")


def _read(directory: str, step: int) -> _Shard:
    """A committed step's leaves: {name: (array as stored, dtype name)},
    each read when it is asked for (see :class:`_Shard`)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    return _Shard(os.path.join(path, "shard_0.npz"), meta)


def restore(directory: str, step: int, state_like):
    """Restore into ``state_like`` (a port ``TrainState``, filled in place
    and returned; names and shapes checked, each leaf cast to the
    template's dtype)."""
    with _read(directory, step) as leaves:
        return load_train_state(state_like, leaves)


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
    step that follows may update the state in place.  In a process
    group every rank calls ``save`` (a placed state is gathered) and
    rank 0 writes."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    def save(self, step: int, state) -> None:
        self.wait()
        host = train_state_to_numpy(state)          # device -> host copy

        def _write():
            if runtime.rank() == 0:
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
