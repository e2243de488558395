"""Meshes of the port: named axes over the ranks of the world.

The reference lays its production runs on a 16x16 (single-pod) or
2x16x16 (multi-pod) TPU mesh (``repro/launch/mesh.py``) and its tests on
a (4, 2) mesh of host devices.  The port's mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group
(:mod:`repro_torch.parallel.runtime`), one rank a device, wrapped with
what the sharding rules read -- ``axis_names`` and the ``shape`` mapping
-- and the process group of every set of axes the sharded model reduces
or gathers over.  A mesh's sizes must multiply to the world size.  A
mesh of one rank needs no process group (a single process makes one).
:func:`make_production_mesh` refuses the reference's meshes unless the
world has the 256 or 512 ranks they take.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.parallel import runtime


class DeviceMesh:
    """Named mesh axes and their sizes over the ranks of the world
    (row-major: rank ``r`` sits at ``np.unravel_index(r, sizes)``).
    ``tmesh`` is the ``torch.distributed`` mesh (``None`` for a mesh of
    one rank outside a process group); :meth:`get_group` gives the
    process group over any set of axes, :meth:`index` this rank's
    position along it."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        self.sizes: Tuple[int, ...] = tuple(int(s) for s in sizes)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} and axes "
                             f"{self.axis_names} differ in length")
        world = runtime.world_size()
        if self.size != world:
            raise ValueError(
                f"mesh {self.sizes} needs {self.size} devices; the world "
                f"has {world} rank{'s' if world != 1 else ''}")
        self.rank = runtime.rank()
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.rank, self.sizes))))
        self.tmesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if runtime.is_distributed():
            self._build()

    def _build(self) -> None:
        from torch.distributed.device_mesh import init_device_mesh
        kind = "cpu" if dist.get_backend() == "gloo" else "cuda"
        self.tmesh = init_device_mesh(kind, self.sizes,
                                      mesh_dim_names=self.axis_names)
        ranks = np.arange(self.size).reshape(self.sizes)
        for n in range(1, len(self.sizes) + 1):
            for sub in itertools.combinations(range(len(self.sizes)), n):
                axes = tuple(self.axis_names[i] for i in sub)
                if n == 1:
                    self._groups[axes] = self.tmesh.get_group(axes[0])
                    continue
                if n == len(self.sizes):
                    self._groups[axes] = dist.group.WORLD
                    continue
                # every rank makes every group, in one order
                rest = [i for i in range(len(self.sizes)) if i not in sub]
                cosets = np.moveaxis(ranks, rest, list(range(len(rest))))
                cosets = cosets.reshape(-1, math.prod(self.sizes[i]
                                                      for i in sub))
                for members in cosets:
                    g = dist.new_group([int(r) for r in members])
                    if self.rank in members:
                        self._groups[axes] = g

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names or ``None``) as a tuple in
        mesh order, axes of size 1 left out."""
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh {self.axis_names} has no axis {a!r}")
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def extent(self, axes) -> int:
        """Ranks along ``axes`` (their sizes' product)."""
        return math.prod(self.shape[a] for a in self.axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major position along ``axes``."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def get_group(self, axes):
        """The process group over ``axes`` (one name, as
        ``torch.distributed``'s ``DeviceMesh.get_group``, or a tuple)
        holding this rank, its ranks in row-major order along them."""
        key = self.axes(axes)
        if not key:
            raise ValueError("no process group over an empty set of axes")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape})"


#: the reference's production meshes
PRODUCTION = {False: (16, 16), True: (2, 16, 16)}


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh (16x16 over (data, model), or
    2x16x16 over (pod, data, model) with ``multi_pod``): built when the
    world has its 256 or 512 ranks, refused otherwise, naming them."""
    shape = PRODUCTION[multi_pod]
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh(shape, axes)


def make_test_mesh(shape: Sequence[int] = (1, 1),
                   axes: Sequence[str] = ("data", "model")) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes`` on the world's ranks; its sizes
    must multiply to the world size."""
    return DeviceMesh(shape, axes)
