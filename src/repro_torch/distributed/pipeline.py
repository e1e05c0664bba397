"""Pipeline parallelism (GPipe fill-drain) over the ranks of a process
group (port of ``repro.distributed.pipeline``).

Layers split into stages, one a rank of the group, and microbatches
stream from stage to stage. With S stages and M microbatches each rank
runs ``M + S - 1`` ticks; at tick t, stage s runs microbatch ``t - s``
(when in range), stage 0 on fresh input, every other stage on what the
stage before it sent at the previous tick. Bubble fraction =
(S-1)/(M+S-1). The production path does not use it (FSDP + TP fit every
assigned config); it is the tested building block for depth-dominated
models.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def pipeline_apply(group, layer_fn, stage_params, x: torch.Tensor, *,
                   microbatches: int) -> torch.Tensor:
    """``y = layers(x)`` with the layers split over the ranks of ``group``.

    ``stage_params``: this rank's contiguous run of layers (a sequence of
    per-layer params, applied in order by ``layer_fn(lp, h)``); ``x``: the
    global input (batch, ...), the same on every rank, batch %
    microbatches == 0. Every rank returns the whole output."""
    group = group if group is not None else dist.group.WORLD
    stages = dist.get_world_size(group)
    s_idx = dist.get_rank(group)
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of {microbatches} "
                         f"microbatches")
    mb = x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))
    out = torch.zeros_like(mb)
    buf = torch.zeros_like(mb[0])
    # the ring of ppermute: stage i sends to i + 1, stage 0's input from
    # the last stage is never read
    nxt = dist.get_global_rank(group, (s_idx + 1) % stages)
    prv = dist.get_global_rank(group, (s_idx - 1) % stages)

    def chunk(h):
        for lp in stage_params:
            h = layer_fn(lp, h)
        return h

    for t in range(microbatches + stages - 1):
        m = t - s_idx                     # microbatch this stage handles
        active = 0 <= m < microbatches
        src = mb[m] if s_idx == 0 and active else buf
        y = chunk(src) if active else src
        if active and s_idx == stages - 1:
            out[m] = y
        if stages > 1:
            y = y.contiguous()
            recv = torch.empty_like(buf)
            ops = [dist.P2POp(dist.isend, y, nxt, group),
                   dist.P2POp(dist.irecv, recv, prv, group)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            buf = recv
    # only the last stage holds the outputs; broadcast them
    dist.broadcast(out, src=dist.get_global_rank(group, stages - 1),
                   group=group)
    return out.reshape(x.shape)


def bubble_fraction(stages: int, microbatches: int) -> float:
    return (stages - 1) / (microbatches + stages - 1)
