"""Model configs served by the port (``--arch <id>``).

Each module exports ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), copied from the
reference package's ``configs/``.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ModelConfig

_MODULES: Dict[str, str] = {
    # the paper's evaluation model (section 4.1)
    "qwen2.5-1.5b": "repro_torch.configs.qwen2_5_1_5b",
    # the SSM family: Mamba-2's SSD, the path of the chunk scan (K10)
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    # the hybrid family: attention (sliding window) beside Mamba-2 heads
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port serves "
                         f"{sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG
