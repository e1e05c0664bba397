"""Explicit collective helpers over a ``torch.distributed`` group (port of
``repro.distributed.collectives``, whose ``shard_map`` bodies they are):

  * ``compressed_psum`` — int8-quantized all-reduce: agree on a per-block
    scale (all-reduce MAX of one float32 a 256-block), quantize, all-reduce
    the int32 accumulation, dequantize. Combine with error feedback
    (``optim.compression``) for unbiasedness.
  * ``moe_all_to_all`` — the expert-parallel token exchange: tokens (E, C,
    d) split on tokens -> split on experts.

the serving collectives of tensor-parallel decode over the model group
(plain functions on tensors, no autograd; each is an ``all_gather`` or an
``all_to_all_single``, which NCCL and gloo both carry):

  * ``all_gather_dim`` — the ranks' shards concatenated along a dimension
    in rank order (q heads, the new token's K/V heads, vocab-split
    logits);
  * ``heads_to_sequence`` — a prompt's K/V split on heads -> split on the
    ring's sequence, every head on each rank;
  * ``exchange_partials`` — each rank's partial reads of all heads ->
    every rank's partials of its own heads, stacked in rank order for the
    merge (``kernels.ref.merge_partials``);

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
    model size;

the two of expert parallelism (the MoE layer's router):

  * ``gather_from_model`` — all-gather along a dimension in rank order
    forward; backward, the gradient summed over the group and the rank's
    slice kept: the router's logits of the rank's experts -> all E;
  * ``reduce_from_data`` — all-reduce over the data groups forward,
    identity backward: the router's statistics of the rank's tokens ->
    the global batch's;

the four of Megatron sequence parallelism, on an activation (B, S, ...)
whose sequence is split over the model group between blocks:

  * ``gather_seq_to_model`` — all-gather of the sequence forward,
    reduce-scatter backward: a block's input, normed on its shard, into
    the projections whose outputs the model axis splits;
  * ``scatter_seq_from_model`` — reduce-scatter onto sequence shards
    forward, all-gather backward: the ranks' partial outputs of a block
    (and of the vocab-split embedding) summed onto the rank's rows;
  * ``split_seq`` — the rank's rows forward, all-gather backward: a whole
    carry, the same on every rank, onto shards;
  * ``gather_seq`` — all-gather forward, the rank's rows of the gradient
    backward: a carry back to the whole sequence (around SOI's compress
    and fuse, before the last row of a prefill);

and fsdp's ``gather_from_data``: a leaf split over the data axes cast to
the compute dtype and all-gathered forward; backward, the gradient summed
over the data axes in float32 and the rank's slice kept.

A reduce-scatter (``reduce_scatter_dim``) is ``reduce_scatter_single``
(``reduce_scatter_tensor`` before it) on NCCL and on gloo over CPU
tensors; on gloo over CUDA tensors (two processes sharing a card) it is
an all-reduce and a slice, the calls gloo carries there.
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


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.size = x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (SUM over ``group``) backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (SUM over ``group``) forward, identity backward."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``all_gather_dim``); backward, the gradient all-reduced (SUM over
    ``group``) and this rank's slice kept — a reduce-scatter."""
    return _GatherFromModel.apply(x, dim % x.dim(), group)


def reduce_from_data(x: torch.Tensor, groups) -> torch.Tensor:
    """All-reduce (SUM) over each group of ``groups`` in turn (the data
    axes), identity backward."""
    for g in groups:
        x = _ReduceFromModel.apply(x, g)
    return x


# ---------------------------------------------------------------------------
# Sequence parallelism and fsdp
# ---------------------------------------------------------------------------

def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, this rank's 1/n slice
    along ``dim`` (rank order): one reduce-scatter on NCCL and on gloo
    over CPU tensors, else (gloo over CUDA tensors) an all-reduce and a
    slice."""
    n = dist.get_world_size(group)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of {size} does not split over "
                         f"{n} ranks")
    if dist.get_backend(group) == "nccl" or x.device.type == "cpu":
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((size // n, *src.shape[1:]), dtype=x.dtype,
                          device=x.device)
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        rs(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return _rows(y, dim, group)


def _rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n slice of ``x`` along ``dim`` (rank order)."""
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _GatherSeqToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class _ScatterSeqFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.dim, ctx.group), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _rows(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.dim, ctx.group), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _rows(grad, ctx.dim, ctx.group), None, None


def gather_seq_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` forward; reduce-scatter backward (the
    ranks' partial gradients summed onto each rank's rows)."""
    return _GatherSeqToModel.apply(x, dim % x.dim(), group)


def scatter_seq_from_model(x: torch.Tensor, dim: int,
                           group) -> torch.Tensor:
    """Reduce-scatter along ``dim`` forward; all-gather backward."""
    return _ScatterSeqFromModel.apply(x, dim % x.dim(), group)


def split_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's rows of ``x`` (the same on every rank) along ``dim``
    forward; all-gather backward."""
    return _SplitSeq.apply(x, dim % x.dim(), group)


def gather_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` forward; this rank's rows of the gradient
    (the same on every rank) backward."""
    return _GatherSeq.apply(x, dim % x.dim(), group)


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups, dtype):
        ctx.dim, ctx.groups, ctx.dtype = dim, groups, x.dtype
        y = x.to(dtype)
        # local_shard cuts along the data axes in their order, the first
        # outermost: gather the innermost first
        for g in reversed(groups):
            y = all_gather_dim(y, dim, g)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.float()
        for grp in ctx.groups:
            g = reduce_scatter_dim(g, ctx.dim, grp)
        return g.to(ctx.dtype), None, None, None


def gather_from_data(x: torch.Tensor, dim: int, groups,
                     dtype: torch.dtype) -> torch.Tensor:
    """fsdp: the whole leaf of the rank's shard ``x`` (split along ``dim``
    over the data groups ``groups``, as ``sharding.local_shard`` cuts it),
    cast to ``dtype`` before the all-gathers; backward, the gradient summed
    over ``groups`` in float32 and the rank's slice kept, in ``x``'s
    dtype."""
    return _GatherFromData.apply(x, dim % x.dim(), tuple(groups), dtype)


# ---------------------------------------------------------------------------
# Serving: tensor-parallel decode with the KV sequence over the model axis
# ---------------------------------------------------------------------------

def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def heads_to_sequence(x: torch.Tensor, group=None) -> torch.Tensor:
    """(B, S, Hloc, dh) split on heads -> (B, S / n, n * Hloc, dh) split on
    the sequence over the n ranks of ``group``: rank r keeps rows [r S/n,
    (r+1) S/n) of every rank's heads, concatenated in rank order — the
    heads of rank j at [j Hloc, (j+1) Hloc), as ``all_gather_dim`` lays
    them out."""
    n = dist.get_world_size(group)
    b, s = x.shape[:2]
    if s % n:
        raise ValueError(f"sequence {s} does not split over {n} ranks")
    # (n destinations, B, S/n, Hloc, dh): chunk j goes to rank j
    send = x.reshape(b, n, s // n, *x.shape[2:]).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv: (n sources, B, S/n, Hloc, dh) -> (B, S/n, n * Hloc, dh)
    return recv.permute(1, 2, 0, *range(3, recv.dim())).reshape(
        b, s // n, n * x.shape[2], *x.shape[3:])


def exchange_partials(x: torch.Tensor, group=None) -> torch.Tensor:
    """(B, H, ...) partials of all H heads -> (n, B, H / n, ...): every
    rank's partials of this rank's heads [r H/n, (r+1) H/n), in rank order
    along the leading axis."""
    n = dist.get_world_size(group)
    b, h = x.shape[:2]
    if h % n:
        raise ValueError(f"{h} heads do not split over {n} ranks")
    send = x.reshape(b, n, h // n, *x.shape[2:]).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv
