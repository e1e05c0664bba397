"""Checkpoint substrate (port of ``repro.checkpoint``): async atomic save
and restore onto a chosen device."""

from repro_torch.checkpoint.checkpointer import (Checkpointer, latest_step,
                                                 restore, save)

__all__ = ["Checkpointer", "save", "restore", "latest_step"]
