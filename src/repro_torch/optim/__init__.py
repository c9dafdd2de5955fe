"""Optimizer of the training step (port of ``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     adamw_update_, cosine_schedule,
                                     global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "cosine_schedule", "global_norm"]
