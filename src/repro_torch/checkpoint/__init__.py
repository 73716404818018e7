"""Checkpoint save and MDTP multi-source restore onto the device."""

from .manager import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
