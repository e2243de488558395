"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  With
no GPU and no explicit CPU request they raise: a measurement or serving
path that silently carried on on the CPU would report CPU numbers under
a device's name.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ["DeviceUnavailable", "resolve_device"]


class DeviceUnavailable(RuntimeError):
    """The requested (or default) CUDA device is not present."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` must be asked for by name.  A
    ``cuda`` without an index is this rank's card: ``cuda:{LOCAL_RANK %
    device_count}`` under ``torch.distributed.run`` (ranks beyond the
    cards share them), the current card otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in \
            os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           % torch.cuda.device_count())
    return dev
