"""LR schedules as pure functions of the step counter (port of
``repro.optim.schedule``). ``step`` may be a Python number or a 0-d tensor
on the card (the optimizer's ``count``): the value is then computed there,
with nothing read back to the host."""

from __future__ import annotations

import math

import torch


def _as_f32(step):
    if torch.is_tensor(step):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    s = _as_f32(step)
    warm = peak_lr * torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi
                                                                 * frac))
    return torch.where(s < warmup, warm, peak_lr * cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1):
    """Warmup-Stable-Decay: linear warmup, flat, linear cooldown."""
    s = _as_f32(step)
    decay_start = total * (1.0 - decay_frac)
    warm = peak_lr * torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)
    cool = peak_lr * torch.clamp((total - s) / max(total - decay_start, 1.0),
                                 0.0, 1.0)
    return torch.where(s < warmup, warm,
                       torch.where(s < decay_start,
                                   torch.full_like(s, peak_lr), cool))
