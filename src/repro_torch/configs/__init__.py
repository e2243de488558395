"""Model configs served by the port (``--arch <id>``).

Each module exports ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), copied from the
reference package's ``configs/``.  ``ARCH_IDS``, ``SHAPES`` and
:func:`all_cells` are the reference's dry-run matrix (the assigned
architectures, without the paper's own qwen2.5-1.5b, by four input
shapes), which :mod:`repro_torch.launch.dryrun` walks.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.models.common import ModelConfig

_MODULES: Dict[str, str] = {
    # the paper's evaluation model (section 4.1)
    "qwen2.5-1.5b": "repro_torch.configs.qwen2_5_1_5b",
    # the SSM family: Mamba-2's SSD, the path of the chunk scan (K10)
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    # the hybrid family: attention (sliding window) beside Mamba-2 heads
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    # the rest of the dense family: OLMo's non-parametric LN and MHA,
    # head_dim != d_model / n_heads (nemo), and the large GQA decoders
    # (qwen1.5-110b at SMOKE width only: ~222 GB of bf16 weights)
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    # the moe family: top-k routing with sort-based capacity dispatch
    # (arctic-480b at SMOKE width only: ~960 GB of bf16 weights)
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    # the vlm family: phi3-mini backbone with a 256-token vision prefix
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    # the encoder-decoder: driven through Model.encode / init_cache(enc=)
    # / decode_n_steps, not served by ServeEngine (as in the reference)
    "whisper-base": "repro_torch.configs.whisper_base",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port serves "
                         f"{sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


#: the assigned architectures (the dry-run matrix's rows), in the
#: reference's order; the paper's own qwen2.5-1.5b is not one of them
ARCH_IDS: List[str] = ["mamba2-780m", "qwen1.5-110b", "olmo-1b",
                       "mistral-nemo-12b", "qwen2.5-32b", "arctic-480b",
                       "moonshot-v1-16b-a3b", "hymba-1.5b",
                       "phi-3-vision-4.2b", "whisper-base"]

#: the four assigned input-shape cells (LM-family shapes)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

#: sub-quadratic families that run the long_500k cell
LONG_CONTEXT_ARCHS = ("mamba2-780m", "hymba-1.5b")


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def all_cells() -> List[Tuple[str, str]]:
    """Every applicable (arch, shape) pair -- the dry-run matrix."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if shape_applicable(a, s)]
