"""Checkpointing in the reference's on-disk layout (the reference's
``checkpoint``)."""

from repro_torch.checkpoint.layout import (empty_train_state,
                                           load_train_state,
                                           train_state_to_numpy)
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer, latest_step,
                                                 prune, restore,
                                                 restore_latest, save)

__all__ = ["AsyncCheckpointer", "empty_train_state", "latest_step",
           "load_train_state", "prune", "restore", "restore_latest", "save",
           "train_state_to_numpy"]
