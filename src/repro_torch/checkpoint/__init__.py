"""Checkpointing (port of `repro.checkpoint`)."""
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint"]
