"""Deterministic synthetic token pipeline (the reference's ``data``)."""

from repro_torch.data.pipeline import DataConfig, DataLoader, synth_batch

__all__ = ["DataConfig", "DataLoader", "synth_batch"]
