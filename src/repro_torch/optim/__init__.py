from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedules import cosine_schedule, sqrt_rescaled_lr

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "sqrt_rescaled_lr"]
