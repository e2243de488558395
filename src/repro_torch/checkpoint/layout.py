"""The training state's on-disk layout: the reference's ``TrainState``
flattened.

The reference's state is ``params``, and ``opt``: ``AdamWState``
``step``, ``mu``, ``nu``, a momentum leaf a ``Q8Moment`` ``q``/``scale``
with int8 moments.  Flattened, its leaves carry the reference's names
(``.params/blocks/attn/wq``, ``.opt/.step``, ``.opt/.mu/.../q``) in its
flatten order (sorted dict keys, NamedTuple field order), every block
leaf stacked ``(L, ...)``.  :func:`train_state_to_numpy` lays the port's
state out so and :func:`load_train_state` reads it back, so a directory
crosses between the two packages.  A bfloat16 leaf travels as its 16-bit
patterns (numpy has no bfloat16).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, reference_path, trainable
from repro_torch.models.registry import param_module
from repro_torch.optim.adamw import Q8Moment, init_adamw
from repro_torch.train.train_loop import TrainState

__all__ = ["train_state_to_numpy", "load_train_state", "empty_train_state"]

#: host dtype of each tensor dtype a training state holds; bfloat16 goes
#: as its bits (numpy has no bfloat16)
_HOST = {torch.float32: (np.float32, "float32"),
         torch.int32: (np.int32, "int32"),
         torch.int8: (np.int8, "int8"),
         torch.bfloat16: (np.int16, "bfloat16")}

#: one reference leaf: (name, the port tensors holding it -- one per
#: layer when stacked --, stacked)
Slot = Tuple[str, List[torch.Tensor], bool]


def _state_slots(state) -> List[Slot]:
    """The reference's flattened ``TrainState``, leaf by leaf, over the
    port state's tensors (see the module docstring)."""
    groups: Dict[str, List[str]] = {}
    tensors = dict(state.params.named_parameters())
    for name in tensors:
        groups.setdefault(reference_path(name)[0], []).append(name)
    order = sorted(groups, key=lambda path: tuple(path.split("/")))
    stacked = {path: reference_path(groups[path][0])[1] is not None
               for path in order}
    slots = [(f".params/{path}", [tensors[n] for n in groups[path]],
              stacked[path]) for path in order]
    slots.append((".opt/.step", [state.opt.step], False))
    for key, moments in ((".mu", state.opt.mu), (".nu", state.opt.nu)):
        for path in order:
            ms = [moments[n] for n in groups[path]]
            if isinstance(ms[0], Q8Moment):
                slots.append((f".opt/{key}/{path}/q", [m.q for m in ms],
                              stacked[path]))
                slots.append((f".opt/{key}/{path}/scale",
                              [m.scale for m in ms], stacked[path]))
            else:
                slots.append((f".opt/{key}/{path}", ms, stacked[path]))
    return slots


def _slot_shape(tensors: List[torch.Tensor], stacked: bool):
    one = tuple(tensors[0].shape)
    return (len(tensors),) + one if stacked else one


def train_state_to_numpy(state) -> List[Tuple[str, np.ndarray, str]]:
    """The port's ``TrainState`` as the reference's flattened tree:
    ``(leaf name, host array, the reference's dtype name)`` in its
    flatten order, block leaves stacked ``(L, ...)``.  A bfloat16 leaf's
    array holds its bits (uint16).  Every array is a copy."""
    out = []
    for name, tensors, stacked in _state_slots(state):
        np_dtype, dt_name = _HOST[tensors[0].dtype]
        arr = np.empty(_slot_shape(tensors, stacked), dtype=np_dtype)
        dst = torch.from_numpy(arr)
        with torch.no_grad():
            for i, t in enumerate(tensors):
                src = t.view(torch.int16) if t.dtype == torch.bfloat16 \
                    else t
                (dst[i] if stacked else dst).copy_(src)
        if dt_name == "bfloat16":
            arr = arr.view(np.uint16)
        out.append((name, arr, dt_name))
    return out


def _host_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A host array as a CPU tensor, read by the dtype its writer named:
    a bfloat16 leaf (the reference's ml_dtypes array, or the ``|V2``
    bytes ``np.savez`` left of one) is taken as its 16-bit patterns."""
    arr = np.asarray(arr, order="C")
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def load_train_state(state, leaves: Mapping[str, Tuple[np.ndarray, str]]):
    """Copy the reference-named ``leaves`` ({name: (array, dtype name)})
    into ``state``'s tensors, each cast to the tensor's dtype, and return
    ``state``.  The names must be exactly the state's and each array of
    the reference's stacked shape."""
    slots = _state_slots(state)
    want = [name for name, _, _ in slots]
    if sorted(want) != sorted(leaves):
        missing = sorted(set(want) - set(leaves))
        extra = sorted(set(leaves) - set(want))
        raise ValueError(f"checkpoint leaves differ from the state's: "
                         f"missing {missing[:4]}, unexpected {extra[:4]}")
    for name, tensors, stacked in slots:
        arr, dt_name = leaves[name]
        shape = _slot_shape(tensors, stacked)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: {tuple(arr.shape)} vs {shape}")
        src = _host_tensor(arr, dt_name)
        for i, t in enumerate(tensors):
            t.copy_(src[i] if stacked else src)
    return state


def empty_train_state(cfg: ModelConfig, device: torch.device,
                      moment_dtype: str = "f32") -> TrainState:
    """A zeroed training state of ``cfg``'s shapes (float32 masters of
    its family's module tracked by autograd, fresh moments), to restore
    into."""
    master = dataclasses.replace(cfg, dtype="float32")
    params = trainable(param_module(master, device))
    return TrainState(params=params, opt=init_adamw(params, moment_dtype))
