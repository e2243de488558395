"""Models of the port: the decoders (dense, moe, ssm, hybrid, vlm) and
the whisper encoder-decoder (config, layers, forward, prefill, decode)."""

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import Model, build_model
from repro_torch.models.transformer import LM, init_lm

__all__ = ["LM", "Model", "ModelConfig", "build_model", "init_lm"]
