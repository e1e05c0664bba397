"""Shared layer primitives: initializers on a ``torch.Generator``, norms and
rotary embeddings (port of ``repro.models.layers``).

Two conventions carried over exactly from the reference:

* RMSNorm multiplies by ``1 + scale`` with a zero-initialised ``scale``
  (``norm_apply`` always takes that form);
* RoPE rotates *interleaved* pairs ``x[..., 0::2]`` / ``x[..., 1::2]``, not
  the rotate-half layout common in PyTorch code.

Tensor parallelism: inside ``model_parallel(group)`` the model runs on its
local shards (heads, ff and vocab split over the ranks of ``group``) and
``to_model`` / ``from_model`` are the collectives of
``distributed.collectives`` (``copy_to_model`` / ``reduce_from_model``);
``channels`` cuts the rank's share of a replicated per-channel tensor;
outside it they return their input, so serving and the unsharded step run
exactly as before. Expert parallelism adds ``gather_from_model`` (the
router's logits of the rank's experts -> all of them) and, inside
``data_parallel(groups)``, the data groups its rows are split over:
``data_size`` (the global token count is the local one times it) and
``reduce_from_data`` (the router's statistics over the global batch).

Sequence parallelism (Megatron's): inside ``sequence_parallel()`` the
trunk splits its block carry (B, S, d) on the sequence over the model axis
wherever the axis divides S (``seq_splits``), and runs the blocks on the
shards inside ``seq_sharded(True)``. There the block's activation passes
``act_to_model`` (an all-gather of the sequence, reduce-scatter backward)
into its split projections and ``act_from_model`` (a reduce-scatter onto
the rank's rows, all-gather backward) out of them, and every replicated
parameter that acts on the rank's rows passes ``seq_param`` (the gradient
summed over the model axis, as ``to_model`` does). A mixer that reads
across positions before its split projections (RWKV's token shift)
gathers the sequence first (``whole_seq``) and hands back the rank's rows
of what it made whole (``own_rows``). Elsewhere the pair is ``to_model`` /
``from_model``, ``seq_param`` and these two the identity.
``to_model`` / ``from_model`` on a parameter or a scalar (the KV weights
a rank holds whole, the per-head norms, the MoE aux loss) keep their copy
and all-reduce everywhere.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import collectives as coll

# the model-axis group of the tensor-parallel region (None: unsharded)
_MODEL_GROUP = None
# the data-axis groups the rows of the region are split over (): the rows
# are the whole batch
_DATA_GROUPS = ()
# sequence parallelism asked for; the block carry split on its sequence
_SEQ_PARALLEL = False
_SEQ_SHARDED = False


@contextlib.contextmanager
def model_parallel(group):
    """Run the model on local shards split over ``group`` (None: a no-op)."""
    global _MODEL_GROUP
    prev, _MODEL_GROUP = _MODEL_GROUP, group
    try:
        yield
    finally:
        _MODEL_GROUP = prev


def model_group():
    """The model-axis group of the enclosing ``model_parallel``, or None."""
    return _MODEL_GROUP


@contextlib.contextmanager
def data_parallel(groups):
    """Run the model on this rank's rows of a batch split over the data
    axes ``groups`` (a sequence of process groups; empty: a no-op)."""
    global _DATA_GROUPS
    prev, _DATA_GROUPS = _DATA_GROUPS, tuple(groups)
    try:
        yield
    finally:
        _DATA_GROUPS = prev


def data_size() -> int:
    """How many data ranks split the rows of the enclosing
    ``data_parallel`` (1 outside it)."""
    return math.prod(dist.get_world_size(g) for g in _DATA_GROUPS)


def reduce_from_data(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks of the enclosing
    ``data_parallel``, identity backward; ``x`` outside it."""
    if not _DATA_GROUPS:
        return x
    return coll.reduce_from_data(x, _DATA_GROUPS)


def model_rank() -> tuple:
    """(this rank's index on the model axis, the axis' size): (0, 1)
    outside ``model_parallel``."""
    if _MODEL_GROUP is None:
        return 0, 1
    return dist.get_rank(_MODEL_GROUP), dist.get_world_size(_MODEL_GROUP)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in rank order,
    the gradient's rank slice summed over them; ``x`` outside
    ``model_parallel``."""
    if _MODEL_GROUP is None:
        return x
    return coll.gather_from_model(x, dim, _MODEL_GROUP)


def to_model(x: torch.Tensor) -> torch.Tensor:
    """Before a projection whose output is split over the model axis (and
    on a replicated parameter that acts on split activations): identity
    forward, gradient summed over the model axis."""
    if _MODEL_GROUP is None:
        return x
    return coll.copy_to_model(x, _MODEL_GROUP)


def from_model(x: torch.Tensor) -> torch.Tensor:
    """After a projection whose input is split over the model axis: the sum
    over the model axis, identity backward."""
    if _MODEL_GROUP is None:
        return x
    return coll.reduce_from_model(x, _MODEL_GROUP)


def channels(x: torch.Tensor, n: int) -> torch.Tensor:
    """A replicated tensor (..., d) that meets activations split on their
    last dimension: ``to_model`` (its gradient is the rank's channels
    only, summed over the model axis) and this rank's ``n`` channels
    ``[r n, (r+1) n)``; all of ``x`` where ``n`` is its width."""
    x = to_model(x)
    if n == x.shape[-1]:
        return x
    r0 = model_rank()[0] * n
    return x[..., r0:r0 + n]


@contextlib.contextmanager
def sequence_parallel(on: bool = True):
    """Let the trunk split its block carry on the sequence over the model
    axis of the enclosing ``model_parallel`` (``seq_splits``)."""
    global _SEQ_PARALLEL
    prev, _SEQ_PARALLEL = _SEQ_PARALLEL, bool(on)
    try:
        yield
    finally:
        _SEQ_PARALLEL = prev


def seq_splits(s: int) -> bool:
    """Whether a carry of ``s`` positions splits over the model axis:
    inside ``sequence_parallel`` and ``model_parallel``, where the axis
    divides ``s`` (else it stays whole, as the reference's ``spec_for``
    replicates it)."""
    return (_SEQ_PARALLEL and _MODEL_GROUP is not None
            and s % dist.get_world_size(_MODEL_GROUP) == 0)


@contextlib.contextmanager
def seq_sharded(on: bool):
    """Run blocks on a carry split on its sequence (``on``) or whole."""
    global _SEQ_SHARDED
    prev, _SEQ_SHARDED = _SEQ_SHARDED, bool(on)
    try:
        yield
    finally:
        _SEQ_SHARDED = prev


def layer_state() -> tuple:
    """What the contexts above have set (the model group, the data groups,
    sequence parallelism and the sharded carry), for ``layer_state_as``."""
    return _MODEL_GROUP, _DATA_GROUPS, _SEQ_PARALLEL, _SEQ_SHARDED


@contextlib.contextmanager
def layer_state_as(state: tuple):
    """Run inside the contexts ``state`` (``layer_state``) recorded: where
    the backward recomputes a rematerialised layer group, after the
    forward's contexts have exited."""
    global _MODEL_GROUP, _DATA_GROUPS, _SEQ_PARALLEL, _SEQ_SHARDED
    prev = layer_state()
    _MODEL_GROUP, _DATA_GROUPS, _SEQ_PARALLEL, _SEQ_SHARDED = state
    try:
        yield
    finally:
        _MODEL_GROUP, _DATA_GROUPS, _SEQ_PARALLEL, _SEQ_SHARDED = prev


def _sharded() -> bool:
    return _SEQ_SHARDED and _MODEL_GROUP is not None


def act_to_model(x: torch.Tensor) -> torch.Tensor:
    """A block's activation (B, S, d) into projections whose outputs the
    model axis splits: on a sequence shard the whole sequence gathered
    (reduce-scatter backward), else ``to_model``."""
    if _sharded():
        return coll.gather_seq_to_model(x, 1, _MODEL_GROUP)
    return to_model(x)


def act_from_model(x: torch.Tensor) -> torch.Tensor:
    """A block's partial output (B, S, d) of split projections: on a
    sequence shard summed onto the rank's rows (all-gather backward), else
    ``from_model``."""
    if _sharded():
        return coll.scatter_seq_from_model(x, 1, _MODEL_GROUP)
    return from_model(x)


def whole_seq(x: torch.Tensor) -> torch.Tensor:
    """A block's activation (B, S, d): on a sequence shard the whole
    sequence gathered, for a mixer that reads across positions before any
    split projection (RWKV's token shift); this rank's rows of the
    gradient backward, which what follows gives every rank alike. Else
    ``x``."""
    if _sharded():
        return coll.gather_seq(x, 1, _MODEL_GROUP)
    return x


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """A whole activation (B, S, d), the same on every model rank: on a
    sequence shard this rank's rows (all-gather backward); else ``x``."""
    if _sharded():
        return coll.split_seq(x, 1, _MODEL_GROUP)
    return x


def seq_param(p):
    """A replicated parameter (or None) that acts on the rank's rows of a
    sequence shard: its gradient summed over the model axis; else ``p``."""
    if p is None or not _sharded():
        return p
    return coll.copy_to_model(p, _MODEL_GROUP)


def split_seq(x: torch.Tensor) -> torch.Tensor:
    """A whole carry (B, S, d), the same on every model rank -> the rank's
    rows (all-gather backward)."""
    return coll.split_seq(x, 1, _MODEL_GROUP)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a carry -> the whole sequence (the rank's rows of
    the gradient backward)."""
    return coll.gather_seq(x, 1, _MODEL_GROUP)


_TRUNC = 3.0


def param(module: nn.Module, name: str, value: torch.Tensor, axes) -> None:
    """Register ``value`` as the parameter ``name`` of ``module`` and record
    its logical axes in ``module.param_axes`` — the port's counterpart of
    the reference's ``A(value, axes)``; ``distributed.sharding.param_axes``
    collects them by qualified name. The axes live on the module, not on
    the tensor, so they survive casts and ``load_state_dict(assign=True)``.
    """
    module.register_parameter(name, nn.Parameter(value))
    if "param_axes" not in module.__dict__:
        module.param_axes = {}
    module.param_axes[name] = tuple(axes)


def trunc_normal(shape, generator: torch.Generator, *, device, scale=1.0,
                 dtype=torch.float32) -> torch.Tensor:
    """``scale`` × a standard normal truncated to [-3, 3] (inverse-CDF
    sampling; the same distribution as ``jax.random.truncated_normal``,
    not the same numbers)."""
    lo = 0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(_TRUNC / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    w = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC)
    return w.mul_(scale).to(dtype)


def dense_init(shape, generator, *, device, scale=None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal init with 1/sqrt(fan_in) scale (fan_in = first axis
    unless overridden)."""
    if scale is None:
        scale = shape[0] ** -0.5
    return trunc_normal(shape, generator, device=device, scale=scale,
                        dtype=dtype)


def embed_init(vocab, d, generator, *, device,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    return w.normal_(generator=generator).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the (1 + scale) convention (zero-init scale)."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(dt)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()) + bias.float()).to(dt)


def norm_apply(kind: str, scale: torch.Tensor, x: torch.Tensor, *,
               bias: torch.Tensor | None = None,
               eps: float = 1e-6) -> torch.Tensor:
    """The block norm of ``kind`` ("rmsnorm" | "layernorm")."""
    if kind == "layernorm":
        return layernorm(scale, bias, x, eps=max(eps, 1e-5))
    return rmsnorm(scale, x, eps=eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, *, pct: float = 1.0, theta: float = 1e4,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated fraction of the head dim."""
    rot = int(head_dim * pct) // 2 * 2
    ar = torch.arange(0, rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, pct: float = 1.0,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, dh) or (..., S, dh); positions: broadcastable to
    (..., S). Rotates interleaved pairs, as ``repro.models.layers``."""
    dh = x.shape[-1]
    rot = int(dh * pct) // 2 * 2
    if rot == 0:
        return x
    inv = rope_freqs(dh, pct=pct, theta=theta, device=x.device)
    ang = positions[..., None].float() * inv                # (..., S, rot/2)
    if x.dim() == positions.dim() + 2:                      # heads present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), x[..., rot:]], dim=-1)
