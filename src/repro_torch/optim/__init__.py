"""Optimizer substrate (port of ``repro.optim``): AdamW over float32
masters, global-norm clipping, LR schedules, int8 gradient compression
with error feedback.

A parameter "tree" here is a flat ``{name: tensor}`` dict, as
``dict(model.named_parameters())`` gives it; grads, moments and error
states are dicts with the same keys. The updates write the masters and
the moments in place."""

from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           compressed_grads)

__all__ = [
    "adamw_init", "adamw_update", "clip_by_global_norm", "global_norm",
    "cosine_schedule", "wsd_schedule", "compress_int8", "decompress_int8",
    "compressed_grads",
]
