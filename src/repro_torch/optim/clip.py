"""Global-norm gradient clipping, in float32 across the whole set of grads
(port of ``repro.optim.clip``).

On a mesh (``split``) a leaf may be a local shard: its sum of squares is
summed over the ranks it is split across (one all-reduce a group, of every
such leaf's sum at once), a replicated leaf counts once, and the leaves
still add up in the dict's order — over one rank the result is the plain
one bit for bit."""

from __future__ import annotations

import torch
import torch.distributed as dist


def global_norm(tree: dict, split: dict | None = None) -> torch.Tensor:
    """sqrt of the sum over leaves (in the dict's order) of each leaf's sum
    of squares, in float32. ``split``: ``{name: groups}`` of the leaves
    that are shards, split over the ranks of each group."""
    sums = {}
    for k, g in tree.items():
        gf = g.float()
        sums[k] = torch.sum(gf * gf)
    by_groups: dict = {}
    for k, groups in (split or {}).items():
        if groups:
            by_groups.setdefault(tuple(groups), []).append(k)
    for groups, names in by_groups.items():
        vec = torch.stack([sums[k] for k in names])
        for group in groups:
            dist.all_reduce(vec, group=group)
        sums.update(zip(names, vec.unbind()))
    total = 0.0
    for k in tree:
        total = total + sums[k]
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: dict, max_norm: float,
                        split: dict | None = None):
    """Returns (clipped grads, pre-clip norm); each grad keeps its dtype."""
    norm = global_norm(grads, split)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm
