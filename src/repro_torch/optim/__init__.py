"""Optimizers of the port: AdamW and its learning-rate schedules."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    tree_flatten, tree_unflatten)
from .schedules import cosine_schedule, wsd_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "tree_flatten", "tree_unflatten", "wsd_schedule"]
