"""Global-norm gradient clipping, in float32 across the whole set of grads
(port of ``repro.optim.clip``)."""

from __future__ import annotations

import torch


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves (in the dict's order) of each leaf's sum
    of squares, in float32."""
    total = 0.0
    for g in tree.values():
        gf = g.float()
        total = total + torch.sum(gf * gf)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Returns (clipped grads, pre-clip norm); each grad keeps its dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm
