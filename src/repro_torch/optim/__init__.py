"""AdamW with fp32 master weights, and the learning-rate schedules."""
from .adamw import OptConfig, adamw_init, adamw_update, global_norm
from .schedules import cosine_schedule, make_schedule, wsd_schedule

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "make_schedule", "wsd_schedule"]
