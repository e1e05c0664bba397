"""Explicit collective helpers over a ``torch.distributed`` group (port of
``repro.distributed.collectives``, whose ``shard_map`` bodies they are):

  * ``compressed_psum`` — int8-quantized all-reduce: agree on a per-block
    scale (all-reduce MAX of one float32 a 256-block), quantize, all-reduce
    the int32 accumulation, dequantize. Combine with error feedback
    (``optim.compression``) for unbiasedness.
  * ``moe_all_to_all`` — the expert-parallel token exchange: tokens (E, C,
    d) split on tokens -> split on experts.

and the two autograd Functions of Megatron-style tensor parallelism on
local shards, the collectives XLA's partitioner inserts for the reference:

  * ``copy_to_model`` — identity forward, all-reduce backward: before a
    projection whose output is split over the model axis (q, k, v, gate,
    up, the vocab-split head), so the replicated input's gradient sums
    every shard's part;
  * ``reduce_from_model`` — all-reduce forward, identity backward: after a
    projection whose input is split (wo, down, the vocab-split embedding).
    ``torch.distributed.nn.functional.all_reduce`` is not this Function:
    its backward all-reduces again, which multiplies the gradients by the
    model size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.optim.compression import BLOCK


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` shipping int8 payloads; returns a new
    tensor of ``x``'s shape and dtype.

    Per-block scales are agreed in float32 first (MAX), so every rank
    quantizes a block against the same scale and the int32 accumulation
    dequantizes exactly — no per-shard-scale mixing error."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    fp = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    # phase 1: a shared per-block scale (one float32 a 256 elements)
    local = torch.amax(torch.abs(fp), dim=1, keepdim=True)
    dist.all_reduce(local, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(local, min=1e-12) / 127.0
    # round half to even, as jnp.round
    q = torch.round(fp / scale).to(torch.int8)
    # phase 2: int8 payloads, accumulated in int32 (no overflow)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    deq = qsum.float() * scale
    return deq.reshape(-1)[:flat.numel()].reshape(x.shape).to(x.dtype)


def moe_all_to_all(tokens: torch.Tensor, group=None) -> torch.Tensor:
    """Tokens (E, C, d) split on tokens -> (E / n, n * C, d) split on
    experts over the n ranks of ``group``: rank r receives every rank's
    rows of experts [r E/n, (r+1) E/n), concatenated along the capacity
    axis in rank order (``jax.lax.all_to_all(split_axis=0, concat_axis=1,
    tiled=True)``). ``all_to_all_single`` splits and concatenates along
    dim 0 only, so the received chunks are moved behind the expert axis."""
    n = dist.get_world_size(group)
    e, c = tokens.shape[:2]
    if e % n:
        raise ValueError(f"{e} experts do not split over {n} ranks")
    out = torch.empty_like(tokens.contiguous())
    dist.all_to_all_single(out, tokens.contiguous(), group=group)
    # out: (n sources, E/n, C, ...) -> (E/n, n sources, C, ...)
    out = out.reshape(n, e // n, c, *tokens.shape[2:]).transpose(0, 1)
    return out.reshape(e // n, n * c, *tokens.shape[2:])


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (SUM over ``group``) backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (SUM over ``group``) forward, identity backward."""
    return _ReduceFromModel.apply(x, group)
