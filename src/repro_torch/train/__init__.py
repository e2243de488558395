"""Training (the reference's ``train``): the train step with remat,
microbatches and AdamW, and the fault-tolerance harness."""

from repro_torch.train.train_loop import (TrainConfig, TrainState,
                                          init_train_state, make_train_step)

__all__ = ["TrainConfig", "TrainState", "init_train_state", "make_train_step"]
