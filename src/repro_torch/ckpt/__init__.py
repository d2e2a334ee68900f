"""Checkpointing (counterpart of ``repro.ckpt``), in the reference's on-disk
layout."""

from .checkpoint import (save_checkpoint, restore_checkpoint, latest_step,
                         checkpoint_bytes, CheckpointManager)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "checkpoint_bytes", "CheckpointManager"]
