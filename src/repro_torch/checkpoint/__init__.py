"""Checkpoints of the train state (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               latest_step, load_checkpoint,
                                               restore_into, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "restore_into", "save_checkpoint"]
