"""Optimizer (the reference's ``optim``): AdamW with f32, bf16 or int8
moments, and the int8 error-feedback compressed all-reduce."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, Q8Moment,
                                     adamw_update, global_norm, init_adamw,
                                     lr_schedule)
from repro_torch.optim.compression import (compress_roundtrip_error,
                                           compressed_psum)

__all__ = ["AdamWConfig", "AdamWState", "Q8Moment", "adamw_update",
           "compress_roundtrip_error", "compressed_psum", "global_norm",
           "init_adamw", "lr_schedule"]
