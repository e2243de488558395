"""Decoders of the port, dense, ssm and hybrid (config, layers, forward,
prefill, decode)."""

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import Model, build_model
from repro_torch.models.transformer import LM, init_lm

__all__ = ["LM", "Model", "ModelConfig", "build_model", "init_lm"]
