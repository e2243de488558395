"""Meshes of the port: one device.

The reference lays its production runs on a 16x16 (single-pod) or
2x16x16 (multi-pod) TPU mesh (``repro/launch/mesh.py``).  The port runs
on one H100, so its mesh is a description -- axis names and sizes, with
the ``.shape`` mapping and ``.axis_names`` the sharding rules read --
whose sizes multiply to 1.  :func:`make_production_mesh` refuses the
reference's meshes by the device count they need, as the reference's
raises when too few devices are visible.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

#: devices the port runs on
PORT_DEVICES = 1


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Named mesh axes and their sizes (a product of 1 on the port)."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} and axes "
                             f"{self.axis_names} differ in length")
        if self.size != PORT_DEVICES:
            raise ValueError(
                f"mesh {self.sizes} needs {self.size} devices; the port "
                f"runs on {PORT_DEVICES}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh (16x16, or 2x16x16 with
    ``multi_pod``): refused, naming the devices it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(shape)
    raise ValueError(f"mesh {shape} needs {n} devices but the port runs on "
                     f"{PORT_DEVICES} (one H100); the dry run targets that "
                     f"one device (mesh 1x1)")


def make_test_mesh(shape: Sequence[int] = (1, 1),
                   axes: Sequence[str] = ("data", "model")) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes``; its sizes must multiply to 1."""
    return DeviceMesh(tuple(int(s) for s in shape), tuple(axes))
