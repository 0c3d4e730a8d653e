"""Manifest-based checkpoints, readable by the reference package too."""
from .ckpt import (CRASH_STAGES, AsyncCheckpointer, ShardedCheckpointer, checkpoint_extra,
                   latest_step, restore_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "CRASH_STAGES", "ShardedCheckpointer", "checkpoint_extra",
           "latest_step", "restore_checkpoint", "save_checkpoint"]
