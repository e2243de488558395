"""The process group a mesh lives on: joining it, and leaving it.

A sharded run is one process per rank.  Under ``python -m
torch.distributed.run --nproc-per-node N`` every process finds its rank,
the world size and the rendezvous address in its environment
(:func:`init_from_env`); a test spawns its ranks itself and hands each
the path of a file store (:func:`process_group`).  The backend follows the
device: NCCL when every rank has a card of its own, gloo otherwise --
the CPU, or several ranks sharing one card (NCCL refuses two ranks on
one device; gloo carries a CUDA tensor through the host).

There is no fallback: a rank that cannot join raises, and so does a
world the caller did not expect.  :func:`shutdown` waits at a barrier
before it leaves, because a rank that destroys its group while a peer
still talks to it closes the peer's connections under it.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["backend_for", "init_from_env", "is_distributed", "rank",
           "shutdown", "world_size", "process_group"]

#: how long a collective (and the rendezvous) may wait for its peers
TIMEOUT = datetime.timedelta(seconds=180)


def is_distributed() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the world: 1 outside a process group."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank: 0 outside a process group."""
    return dist.get_rank() if is_distributed() else 0


def backend_for(device: torch.device, world: int) -> str:
    """NCCL when ``device`` is a card and the world has a card per rank,
    gloo otherwise."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _join(init_method: str, rank_: int, world: int,
          device: torch.device) -> None:
    if is_distributed():
        raise RuntimeError("this process has already joined a process "
                           "group")
    backend = backend_for(device, world)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world, timeout=TIMEOUT, **kw)


def init_from_env(device: torch.device) -> int:
    """Join the group ``torch.distributed.run`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); returns the world
    size.  Raises if the variables are missing."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"not launched by torch.distributed.run: "
                           f"{', '.join(missing)} unset")
    world = int(os.environ["WORLD_SIZE"])
    _join("env://", int(os.environ["RANK"]), world, device)
    return world


def shutdown() -> None:
    """Leave the group: a barrier first, so no peer is mid-collective."""
    if is_distributed():
        dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(path: str, rank_: int, world: int,
                  device: torch.device):
    """Join a group of ``world`` ranks through the file store at ``path``
    (a file that does not exist yet, one per group); :func:`shutdown`
    on a clean exit.  On an exception the group is left without the
    barrier (the peers may never reach it) and the exception goes on."""
    _join(f"file://{path}", rank_, world, device)
    try:
        yield
    except BaseException:
        dist.destroy_process_group()
        raise
    shutdown()
