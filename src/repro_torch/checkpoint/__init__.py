"""Checkpoint save and MDTP multi-source restore onto the device."""

from .manager import (CheckpointManager, RestoreOptions, latest_step,
                      restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "RestoreOptions", "latest_step",
           "restore_checkpoint", "save_checkpoint"]
