"""Models of the port: the decoders (dense, moe, ssm, hybrid, vlm) and
the whisper encoder-decoder (config, layers, forward, prefill, decode)."""

from repro_torch.models.common import (ModelConfig, MoEConfig, SSMConfig,
                                       cross_entropy, pad_vocab)
from repro_torch.models.registry import Model, build_model
from repro_torch.models.transformer import LM, init_lm

__all__ = ["LM", "Model", "ModelConfig", "MoEConfig", "SSMConfig",
           "build_model", "cross_entropy", "init_lm", "pad_vocab"]
