"""Optimizer (the reference's ``optim``): AdamW with f32, bf16 or int8
moments.  ``compression.py``'s ``compressed_psum`` needs a collective
axis and comes with the parallel layer."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, Q8Moment,
                                     adamw_update, global_norm, init_adamw,
                                     lr_schedule)

__all__ = ["AdamWConfig", "AdamWState", "Q8Moment", "adamw_update",
           "global_norm", "init_adamw", "lr_schedule"]
