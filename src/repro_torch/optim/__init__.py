"""AdamW with fp32 master weights, and the learning-rate schedules."""
from .adamw import OptConfig, adamw_init, adamw_update, global_norm, opt_state_specs
from .schedules import cosine_schedule, make_schedule, wsd_schedule

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm", "opt_state_specs",
           "cosine_schedule", "make_schedule", "wsd_schedule"]
