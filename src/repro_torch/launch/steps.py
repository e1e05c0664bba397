"""Train / serve step builders (port of ``repro.launch.steps``).

``make_train_step`` assembles the production step: microbatched gradient
accumulation in float32, mixed precision (float32 masters, bf16 compute:
``models.transformer.loss_sums`` casts inside the differentiated
function), global-norm clipping, optional int8 gradient compression with
error feedback, AdamW on a cosine LR.

On a mesh (``rules`` and a ``DeviceMesh`` of ``launch.mesh``) the step is
data x tensor parallel, computed on local shards with explicit collectives
— the work ``shard_map`` and XLA's partitioner do for the reference:

  * the parameters are the DTensors of ``sharding.shard_params`` (heads,
    kv heads, ff, vocab, a MoE's experts and its router's columns, MLA's
    up-projections and the RG-LRU's channels split over the model axis,
    the rest replicated); the model runs on their ``to_local()`` shards
    inside ``layers.model_parallel`` (Megatron's collectives: ``to_model``
    before a split projection, ``from_model`` after, a vocab-split
    embedding and cross entropy) and ``layers.data_parallel`` (the data
    groups a MoE layer routes and counts its aux loss over);
  * KV heads that the model axis does not split but whose count divides
    it (MQA's one, 2 on 4 ranks) stay replicated beside the split query
    heads, as the reference's rules leave them: each rank projects every
    KV head and its query heads read theirs (``models.attention``);
  * expert parallelism (``models.moe.moe_apply``): a MoE layer's
    dispatch groups are the global microbatch's, its router's logits are
    gathered to all experts, each model rank runs its experts' entries
    and the ranks' outputs are summed; no all-to-all, as a data rank's
    tokens are replicated over the model axis;
  * each rank's batch is its rows of every global microbatch
    (``local_batch``); each microbatch's loss is the global masked mean —
    the NLL sum and the target count are both summed over the data axes —
    plus the MoE routers' aux loss over the global microbatch, and the
    gradients are summed over the data axes;
  * the clip's norm sums each split leaf's squares over its split axes;
    AdamW updates each shard in place;
  * ``rules.fsdp``: every leaf whose ``"embed"`` dimension the data axes
    divide is split along it over them (``sharding.shard_params``), so its
    float32 master, gradient and both moments are 1/D a rank. A step casts
    each such shard to the compute dtype and all-gathers the whole leaf
    over the data axes (``collectives.gather_from_data``, through
    ``loss_sums``' ``gather`` hook): a leaf outside the blocks once a
    microbatch, a block's inside its layer group — again where the
    backward recomputes a rematerialised group (``cfg.remat``), so no
    whole gathered copy of the blocks lives across the step; the gathered
    copy's gradient is summed over the data axes in float32 and the
    rank's slice kept — that sum takes the place of the leaf's data-axis
    all-reduce. A leaf the data axes do not divide stays replicated and
    is all-reduced as before;
  * ``rules.seq_shard``: Megatron sequence parallelism
    (``layers.sequence_parallel``): between blocks the carry (B, S, d) is
    split on its sequence over the model axis wherever the axis divides S
    (else whole, as the reference's ``spec_for`` falls back); a block
    norms its rows, gathers the sequence into its split projections and
    reduce-scatters their sum back onto its rows; the embedding's vocab
    sum is a reduce-scatter; SOI's compress, extrapolation and fusion and
    the head's cross entropy see the whole sequence (``models.transformer
    .trunk``).

Every model family runs on a mesh: GQA, MoE, MLA, the RG-LRU, RWKV
(``models.rwkv``: its heads over the model axis), the encoder-decoder
(whisper: the encoder's heads split like the decoder's) and the prefix-LM
(paligemma). A vocab that the model axis does not divide stays whole on
every rank, as the reference's ``spec_for`` replicates it: the embedding
looks up every row and each rank computes every logit, so the embedding's
and the head's gradients are every rank's alike and are not summed over
the model axis.

Refused on a mesh (``NotImplementedError``, ROADMAP.md Queue 1 item 8): a
model axis that does not divide some other split dimension (query heads,
ff, the experts, RWKV's heads; KV heads only where their count does not
divide the axis either, 3 on 2 ranks say), ``compress`` where the model
axis has more than one rank or fsdp splits leaves over more than one data
rank (a shard's 256-blocks are not the whole leaf's), and a MoE layer
whose global dispatch groups do not split over the data ranks
(``moe_apply``).

``make_prefill`` and ``make_serve_step`` on a mesh serve data x tensor
parallel, on local shards with explicit collectives, the decode state in
``launch.specs.decode_state_specs``' layout: each data rank runs its rows
of the global batch; the prefill runs on the rank's heads and hands every
attention ring back with the KV *sequence* over the model axis (every KV
head, rows ``[r S/M, (r+1) S/M)``, or the whole ring where M does not
divide S; an MLA layer's latent and rope lanes alike); a decode step
gathers q (and k and v where they are split; MLA: ``q_lat`` and
``q_rope``) to all heads, writes the token on the rank holding its ring
slot, reads all heads over the rank's rows with ``decode_attention(...,
return_lse=True)`` (MLA: the plain ``mla_decode_attention``'s), and merges
each head's M partials in rank order on the rank that owns the head
(``models.attention``); the logits are gathered to the full vocabulary.
An RG-LRU layer's state holds the rank's channels, an RWKV layer's ``S``
its heads; an encoder-decoder's cross K/V hold every KV head over the
rank's frames, and a decode step reads them as it reads a split ring
(``models.attention.cross_decode``). A MoE layer routes as
in training (its rows' groups are the global batch's where the data axes
split the rows), without the aux loss. With ``fsdp`` each step gathers the
data-split leaves over the data axes (after the cast, no autograd); with
``seq_shard`` the prefill runs the training step's sequence-parallel
layout (the decode state's layout does not change), and a decode step's
one position stays whole.
They refuse what the train step refuses; the engine (``SOIEngine``),
paged pools and speculation run without a mesh only, as in the
reference.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelCfg
from repro_torch.distributed.collectives import (all_gather_dim,
                                                 gather_from_data)
from repro_torch.distributed.sharding import (ShardingRules,
                                              logical_constraint)
from repro_torch.launch.mesh import data_axes_of
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.models.layers import (data_parallel, model_parallel,
                                       sequence_parallel)
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               compressed_grads, cosine_schedule)


def _noc(x, axes):
    return x


def make_constrain(rules: ShardingRules, mesh):
    """``constrain(x, axes)``: ``logical_constraint`` on ``mesh``, or the
    identity without one."""
    if rules is None or mesh is None:
        return _noc
    return functools.partial(logical_constraint, rules=rules, mesh=mesh)


def make_train_step(cfg: ModelCfg, rules: ShardingRules = None, mesh=None,
                    *, microbatches: int = 1, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    grad_clip: float = 1.0, compress: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``params`` is the model (its float32 masters and
    ``opt_state``'s moments are updated in place), ``batch`` holds tokens and
    targets (B, S) on the model's device; metrics ``loss``, ``xent``,
    ``aux``, ``grad_norm`` and ``lr`` are 0-d tensors there (no host
    read). With a ``mesh`` see the module docstring: ``batch`` is this
    rank's ``local_batch``."""
    if mesh is not None:
        return _sharded_train_step(
            cfg, rules or ShardingRules(data_axes=data_axes_of(mesh)), mesh,
            microbatches=microbatches, peak_lr=peak_lr, warmup=warmup,
            total_steps=total_steps, grad_clip=grad_clip, compress=compress)

    def grads_of(params, batch):
        named = dict(params.named_parameters())
        loss, metrics = T.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(named, grads)))

    def train_step(params, opt_state: dict, batch: dict):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            bsz = batch["tokens"].shape[0]
            if bsz % microbatches:
                raise ValueError(f"batch {bsz} is not a multiple of "
                                 f"{microbatches} microbatches")
            mb = bsz // microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.named_parameters()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, _, g_i = grads_of(params, part)
                for k, g in g_i.items():
                    grads[k] += g.float()
                lsum = lsum + l_i
            grads = {k: g / microbatches for k, g in grads.items()}
            # as the reference reports them: the microbatches' mean total
            # (cross entropy + aux) as "xent", and "aux" 0
            loss = lsum / microbatches
            metrics = {"xent": loss, "aux": torch.zeros_like(loss)}

        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        if compress:
            grads, new_err = compressed_grads(grads, opt_state.get("err"))
        lr = cosine_schedule(opt_state["count"], peak_lr=peak_lr,
                             warmup=warmup, total=total_steps)
        adamw_update(grads, opt_state, dict(params.named_parameters()),
                     lr=lr)
        if compress:
            opt_state["err"] = new_err
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# The data x tensor-parallel step
# ---------------------------------------------------------------------------

def _data_index(mesh, data_axes) -> tuple:
    """(this rank's index over the data axes, their size), row-major in the
    order ``data_axes`` names them."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx, size = 0, 1
    for a in data_axes:
        n = mesh.size(names.index(a))
        idx = idx * n + coord[names.index(a)]
        size *= n
    return idx, size


def local_batch(batch: dict, mesh, microbatches: int = 1,
                data_axes=None) -> dict:
    """This rank's rows of a global batch (B, ...) for the sharded step:
    its 1/D share of every global microbatch ``[i B/M, (i+1) B/M)``, the
    microbatches one after another — so microbatch i of the step is the
    reference's global microbatch i, split over the D data ranks."""
    data_axes = tuple(data_axes or data_axes_of(mesh))
    d, n = _data_index(mesh, data_axes)
    bsz = batch["tokens"].shape[0]
    if bsz % (microbatches * n):
        raise ValueError(f"batch {bsz} does not split into {microbatches} "
                         f"microbatches over {n} data ranks")
    mb = bsz // microbatches
    rows = mb // n
    idx = torch.cat([torch.arange(i * mb + d * rows, i * mb + (d + 1) * rows)
                     for i in range(microbatches)])
    return {k: v[idx.to(v.device)] for k, v in batch.items()}


def _refuse(what: str, step: str = "train"):
    raise NotImplementedError(
        f"the sharded {step} step does not run {what} yet (ROADMAP.md, "
        f"Queue 1 item 8)")


def _check_layout(cfg: ModelCfg, rules: ShardingRules, model_size: int,
                  step: str = "train"):
    """Refuse a layout the step cannot run: a dimension the rules split
    over the model axis that the axis does not divide falls back to
    replicated (``sharding.spec_for``), and a replicated ff column or
    query head beside split ones is not the Megatron layout the model
    computes; nor is an RWKV head cut by the split of its channels.
    Replicated KV heads beside split query heads are: where their count
    divides the axis, each rank's query heads read one of them
    (``models.attention``). So is a whole vocab: the embedding and the
    head then run unsplit on every rank."""
    from repro_torch.launch.specs import abstract_params
    shapes, axes = abstract_params(cfg)
    table = rules.table()
    bad = set()
    for k, names in axes.items():
        for name, dim in zip(names, shapes[k].shape):
            if (table.get(name) != rules.model_axis
                    or dim % model_size == 0 or name == "vocab"
                    or (name == "kv_heads" and model_size % dim == 0)):
                continue
            bad.add(f"axis {name!r} dim {dim} % mesh {model_size} != 0 -> "
                    f"replicated")
    for b in T.layer_blocks(cfg):
        if b.rwkv is not None and b.rwkv.n_heads % model_size:
            bad.add(f"rwkv heads {b.rwkv.n_heads} % mesh {model_size} != 0")
    if model_size > 1 and bad:
        _refuse(f"a model axis of {model_size} that does not divide every "
                f"split dimension ({sorted(bad)})", step)


def _data_split(params: dict, mesh, data_axes) -> dict:
    """``{name: (dimension, data axes)}`` of the DTensor leaves split over
    data axes of more than one rank (fsdp's ``"embed"``), those axes in
    ``data_axes``' order; every data axis shards the same dimension, as
    ``sharding.placements`` lays out one spec entry. A data axis of one
    rank holds the whole leaf: nothing to gather over it."""
    from torch.distributed.tensor import Shard
    names = list(mesh.mesh_dim_names)
    out = {}
    for k, p in params.items():
        axes = tuple(a for a in data_axes
                     if mesh.size(names.index(a)) > 1
                     and isinstance(p.placements[names.index(a)], Shard))
        if axes:
            (dim,) = {p.placements[names.index(a)].dim for a in axes}
            out[k] = (dim, axes)
    return out


def _sharded_train_step(cfg: ModelCfg, rules: ShardingRules, mesh, *,
                        microbatches, peak_lr, warmup, total_steps,
                        grad_clip, compress):
    from torch.distributed.tensor import DTensor, Shard
    names = list(mesh.mesh_dim_names)
    data_axes = tuple(rules.data_axes)
    model_size = mesh.size(names.index(rules.model_axis))
    n_data = _data_index(mesh, data_axes)[1]
    if compress and rules.fsdp and n_data > 1:
        _refuse(f"compress=True with fsdp over {n_data} data ranks (a "
                f"shard's 256-blocks are not the whole leaf's)")
    if compress and model_size > 1:
        _refuse(f"compress=True on a model axis of {model_size} ranks (a "
                f"shard's 256-blocks are not the whole leaf's)")
    _check_layout(cfg, rules, model_size)
    mp_group = mesh.get_group(rules.model_axis)
    dp_groups = [mesh.get_group(a) for a in data_axes]

    def dp_sum(t):
        for g in dp_groups:
            dist.all_reduce(t, group=g)
        return t

    def split_groups(params: dict) -> dict:
        out = {}
        for k, p in params.items():
            if not isinstance(p, DTensor) or p.device_mesh != mesh:
                raise ValueError(f"parameter {k!r} is not a DTensor on the "
                                 f"step's mesh (sharding.shard_params)")
            out[k] = [mesh.get_group(names[i])
                      for i, pl in enumerate(p.placements)
                      if isinstance(pl, Shard)]
        return out

    def train_step(params, opt_state: dict, batch: dict):
        named = dict(params.named_parameters())
        split = split_groups(named)
        local = {k: p.to_local().detach() for k, p in named.items()}
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in local.items()}
        # fsdp: each data-split leaf cast and gathered whole where it is
        # used (a block's in its layer group); its gradient comes back
        # summed over the data axes
        gather = {k: functools.partial(
            gather_from_data, dim=d, groups=[mesh.get_group(a) for a in axes])
            for k, (d, axes) in _data_split(named, mesh, data_axes).items()}
        bsz = batch["tokens"].shape[0]
        if bsz % microbatches:
            raise ValueError(f"batch {bsz} is not a multiple of "
                             f"{microbatches} microbatches")
        mb = bsz // microbatches

        def grads_of(part):
            # the loss of the reference's loss_fn: the global masked mean
            # plus the MoE routers' aux loss, each layer's over the global
            # microbatch (summed in layer order, as loss_fn sums them)
            terms = []
            with model_parallel(mp_group), data_parallel(dp_groups), \
                    sequence_parallel(rules.seq_shard):
                nll, count = T.loss_sums(params, cfg, part, tensors=leaves,
                                         aux=terms, gather=gather)
                aux = torch.zeros((), dtype=torch.float32, device=nll.device)
                for a in terms:
                    aux = aux + a
                denom = torch.clamp(dp_sum(count.detach().clone()), min=1.0)
                g = torch.autograd.grad(nll / denom + aux,
                                        list(leaves.values()))
            xent = dp_sum(nll.detach().clone()) / denom
            aux = aux.detach()
            return xent + aux, xent, aux, dict(zip(leaves, g))

        if microbatches == 1:
            loss, xent, aux, grads = grads_of(batch)
            metrics = {"xent": xent, "aux": aux}
        else:
            grads = {k: torch.zeros(t.shape, dtype=torch.float32,
                                    device=t.device)
                     for k, t in local.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(microbatches):
                l_i, _, _, g_i = grads_of({k: v[i * mb:(i + 1) * mb]
                                           for k, v in batch.items()})
                for k, g in g_i.items():
                    grads[k] += g.float()
                lsum = lsum + l_i
            grads = {k: g / microbatches for k, g in grads.items()}
            # as the reference reports them: the microbatches' mean total
            # (cross entropy + aux) as "xent", and "aux" 0
            loss = lsum / microbatches
            metrics = {"xent": loss, "aux": torch.zeros_like(loss)}
        for k, g in grads.items():
            if k not in gather:
                dp_sum(g)

        grads, gnorm = clip_by_global_norm(grads, grad_clip, split)
        if compress:
            grads, new_err = compressed_grads(grads, opt_state.get("err"))
        lr = cosine_schedule(opt_state["count"], peak_lr=peak_lr,
                             warmup=warmup, total=total_steps)
        moments = {t: {k: v.to_local() for k, v in opt_state[t].items()}
                   for t in ("mu", "nu")}
        moments["count"] = opt_state["count"]
        adamw_update(grads, moments, local, lr=lr)
        opt_state["count"] = moments["count"]
        if compress:
            opt_state["err"] = new_err
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class _OnTensors(nn.Module):
    """``fn(model, *args)`` as a forward, so that
    ``torch.func.functional_call`` runs it on other tensors than the
    model's parameters (a sharded step's local shards)."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _local_tensors(params, mesh, dt, data_axes=()) -> dict:
    """``{name: the rank's shard}`` of a model whose parameters are
    DTensors on ``mesh`` (``sharding.shard_params``), in the compute dtype
    ``dt`` (a no-op where the model was cast before it was sharded); a
    leaf split over ``data_axes`` (fsdp) gathered whole over them after
    the cast (``_data_split``)."""
    from torch.distributed.tensor import DTensor
    named = dict(params.named_parameters())
    for k, p in named.items():
        if not isinstance(p, DTensor) or p.device_mesh != mesh:
            raise ValueError(f"parameter {k!r} is not a DTensor on the "
                             f"step's mesh (sharding.shard_params)")
    split = _data_split(named, mesh, data_axes)
    out = {}
    for k, p in named.items():
        t = p.to_local().detach().to(dt)
        if k in split:
            dim, axes = split[k]
            # the innermost data axis first: local_shard cuts the
            # outermost first
            for a in reversed(axes):
                t = all_gather_dim(t, dim, mesh.get_group(a))
        out[k] = t
    return out


def _ring_lengths(cfg: ModelCfg, max_len: int) -> dict:
    """``{state list: [logical ring length of each layer, None for a layer
    without attention]}`` of a dense decode state of ``max_len``."""
    from repro_torch.models.decode import soi_mid_len

    def rings(blocks, length):
        return [None if b.attn is None else
                length if b.attn.window is None else min(length,
                                                         b.attn.window)
                for b in blocks]

    blocks = T.layer_blocks(cfg)
    if cfg.soi is None:
        return {"segments": rings(blocks, max_len)}
    out, i = {}, 0
    for name, part in zip(("pre", "mid", "post"), T.soi_partition(cfg)):
        n = sum(seg.n_layers for seg in part)
        out[name] = rings(blocks[i:i + n], max_len if name != "mid" else
                          soi_mid_len(max_len, cfg.soi.stride))
        i += n
    return out


class _ServeLayout:
    """What a serving step on a mesh needs of it, checked once: the model
    group, this rank's place on the model and data axes, and the compute
    dtype."""

    def __init__(self, cfg: ModelCfg, rules: ShardingRules, mesh):
        self.rules = rules or ShardingRules(data_axes=data_axes_of(mesh))
        names = list(mesh.mesh_dim_names)
        self.m = mesh.size(names.index(self.rules.model_axis))
        _check_layout(cfg, self.rules, self.m, step="serve")
        self.mesh = mesh
        self.group = mesh.get_group(self.rules.model_axis)
        self.r = dist.get_rank(self.group)
        self.d, self.n_data = _data_index(mesh, tuple(self.rules.data_axes))
        self.data_groups = [mesh.get_group(a) for a in self.rules.data_axes]
        self.dt = T._dtype(cfg)

    def rows(self, b: int) -> slice:
        """This data rank's rows of a global batch of ``b``: its 1/D share,
        or every row where D does not divide ``b`` (the specs then
        replicate the batch)."""
        if b % self.n_data:
            return slice(0, b)
        per = b // self.n_data
        return slice(self.d * per, (self.d + 1) * per)

    def run(self, params, fn, b: int, *args):
        """``fn(params, *args)`` on the rank's shards of a global batch of
        ``b`` rows, inside ``model_parallel`` over the model group and,
        where the data axes split the rows, ``data_parallel`` over them (a
        MoE layer routes on the global batch's groups), and inside
        ``sequence_parallel`` with ``seq_shard``."""
        tensors = _local_tensors(params, self.mesh, self.dt,
                                 tuple(self.rules.data_axes))
        split = self.rows(b) != slice(0, b)
        with model_parallel(self.group), \
                data_parallel(self.data_groups if split else ()), \
                sequence_parallel(self.rules.seq_shard):
            return torch.func.functional_call(
                _OnTensors(params, fn),
                {"model." + k: v for k, v in tensors.items()}, args)


def make_serve_step(cfg: ModelCfg, rules: ShardingRules = None, mesh=None,
                    *, max_len: int | None = None):
    """One serving step, SOI and plain configs alike: the engine's
    ``generate_step`` (per-slot clocks, SOI phase resolved per step).
    ``serve_step(params, state, token)`` takes tokens (B,) and returns
    (logits, state), the state updated in place.

    With a ``mesh``: ``params`` as ``sharding.shard_params`` lays them out
    (cast to the compute dtype before sharding, or every step casts the
    shards), ``state`` the local shards a ``make_prefill`` step on the same
    mesh returned, ``token`` the global (B,) tokens; the step runs this data
    rank's rows and returns their logits (B/D, V) in float32, full
    vocabulary. ``max_len`` (the prefill's) is required where the model
    axis has more than one rank: it says which rings split over it."""
    from repro_torch.engine.step import generate_step

    def step_fn(params, state, token):
        return generate_step(params, cfg, state, token)

    if mesh is None:
        return step_fn
    layout = _ServeLayout(cfg, rules, mesh)
    if layout.m > 1 and max_len is None:
        raise ValueError(
            "make_serve_step on a model axis of more than one rank needs "
            "max_len (the prefill's): a rank's shard of a ring does not say "
            "whether the ring's rows split over the model axis")
    rings = _ring_lengths(cfg, max_len) if layout.m > 1 else {}
    frames = None if cfg.encoder is None else cfg.encoder.n_frames

    def cross_view(state: dict, rows: slice) -> dict:
        """The cross read's entries of the rank's rows: positions and
        query clocks (replicated) cut to them, and on a model axis of more
        than one rank the positions to the rank's frames and every cross
        cache marked ``KV_SHARD``."""
        pos = state["cross_pos"][rows]
        out = {"cross_q_pos": state["cross_q_pos"][rows]}
        if layout.m > 1:
            split = frames % layout.m == 0
            f_loc = frames // layout.m if split else frames
            for c in state["cross_kv"]:
                if c is not None and c["k"].shape[1] != f_loc:
                    raise ValueError(
                        f"cross K/V of {c['k'].shape[1]} frames on this "
                        f"rank: {frames} frames lay out {f_loc}")
            if split:
                pos = pos[:, layout.r * f_loc:(layout.r + 1) * f_loc]
            out["cross_kv"] = [
                None if c is None else
                dict(c, **{attn.KV_SHARD: (layout.r, layout.m, split)})
                for c in state["cross_kv"]]
        out["cross_pos"] = pos.contiguous()
        return out

    def local_view(state: dict, rows: slice) -> dict:
        view = dict(state, t=state["t"][rows])
        if "cross_kv" in state:
            view.update(cross_view(state, rows))
        for name, lens in rings.items():
            caches = []
            for c, ring in zip(state[name], lens):
                if ring is not None:
                    split = ring % layout.m == 0
                    want = ring // layout.m if split else ring
                    if c["pos"].shape[1] != want:
                        raise ValueError(
                            f"a {name} ring of {c['pos'].shape[1]} rows on "
                            f"this rank: max_len {max_len} lays out {want}")
                    c = dict(c, **{attn.KV_SHARD: (layout.r, layout.m,
                                                   split)})
                caches.append(c)
            view[name] = caches
        return view

    def serve_step(params, state, token):
        b = token.shape[0]
        rows = layout.rows(b)
        logits, _ = layout.run(params, step_fn, b, local_view(state, rows),
                               token[rows])
        # every slot's clock advances one a step, those of the other data
        # ranks' rows too: the clocks are replicated
        t = state["t"]
        t[:rows.start].add_(1)
        t[rows.stop:].add_(1)
        return logits, state

    return serve_step


def make_prefill(cfg: ModelCfg, rules: ShardingRules = None, mesh=None, *,
                 max_len: int | None = None):
    """``prefill_step(params, batch) -> (logits, state)`` over
    ``batch["tokens"]`` (B, S) (and the stubs ``patch_embeds`` /
    ``encoder_frames``), caches of ``max_len`` rows (default S).

    With a ``mesh`` (``params`` as ``make_serve_step`` takes them) the step
    runs this data rank's rows of the global batch on the rank's heads
    (``flash_attention`` on the local q, k and v) and returns their logits
    (B/D, V) and the decode state as local shards of
    ``launch.specs.decode_state_specs``' layout, leaf for leaf: rows over
    the data axes, each attention ring's rows over the model axis (every
    KV head on each rank) where the axis divides them, the clocks ``t``
    (B,) and an encoder-decoder's cross-read positions (B, F) and query
    clocks (B,) replicated."""
    from repro_torch.models import decode as D

    def prefill_fn(params, batch):
        return D.prefill(params, cfg, batch["tokens"],
                         prefix_embeds=batch.get("patch_embeds"),
                         encoder_frames=batch.get("encoder_frames"),
                         max_len=max_len)

    if mesh is None:
        return prefill_fn
    layout = _ServeLayout(cfg, rules, mesh)

    def prefill_step(params, batch):
        b = batch["tokens"].shape[0]
        rows = layout.rows(b)
        mine = {k: v[rows] for k, v in batch.items()}
        logits, state = layout.run(params, prefill_fn, b, mine)
        if rows != slice(0, b):
            # the replicated leaves: every row the same, so the global
            # batch's from the rank's first
            state["t"] = state["t"][:1].repeat(b)
            if "cross_pos" in state:
                state["cross_pos"] = state["cross_pos"][:1].repeat(b, 1)
                state["cross_q_pos"] = state["cross_q_pos"][:1].repeat(b)
        return logits, state

    return prefill_step
