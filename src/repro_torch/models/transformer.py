"""The unified LM with SOI (port of ``repro.models.transformer``: the
forward, the whisper encoder, and the training loss ``loss_fn``, with the
MoE router's load-balancing loss summed over every MoE layer).

The model is an ``nn.Module``: token embedding, one ``Block`` per layer in an
``nn.ModuleList`` over every segment in order (the reference stacks a scanned
segment's layers on a leading axis and keeps an unscanned one as a list),
the final norm, the untied ``lm_head (d, vocab)`` of configs that do not tie
it to the embedding, and — for SOI configs — the S-CC compress conv
``soi_compress (stride, d, d)`` and the skip fusion ``soi_fuse (2d, d)``.
A block mixes the sequence with attention (GQA or MLA) or with the RG-LRU
(recurrentgemma), and channels with an MLP (gated SwiGLU / GeGLU, or the
plain squared-ReLU / GeLU) or a MoE, each behind an RMSNorm or — with
``norm="layernorm"`` (nemotron) — a LayerNorm that carries a bias beside
its scale; the final norm takes the first block's kind. An RWKV-6 block
(rwkv6) is a time mix and a channel mix behind ``ln1``/``ln2``. A decoder
block of an encoder-decoder config (whisper) reads the encoder output
through cross attention (``lnx``, ``cross``) between its self attention
and its MLP. Gemma configs scale the embeddings by sqrt(d)
(``embed_scale``) and soft-cap the logits (``logits_softcap``).

Frontends are stubs, as in the reference: whisper's encoder takes
precomputed frame embeddings (``encode``), and paligemma's image prefix
arrives as ``prefix_embeds`` ahead of the token embeddings; its first
``frontend_len`` positions attend bidirectionally (``prefix_lm``). A
config with ``learned_pos_len`` adds a learned position table
(``pos_embed``) to the token embeddings.

SOI-LM (cfg.soi): layers [first_layer, last_layer) form the *compressed
middle* — a width-stride stride-stride causal conv compresses time before
the middle; duplication extrapolation + skip fusion restores full rate after
it ("fp" shifts the middle one token into the future).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn

import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockCfg, ModelCfg, SOILMCfg
from repro_torch.core.stmc import causal_conv1d
from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rgm
from repro_torch.models import rwkv as rkm
from repro_torch.models.layers import dense_init, embed_init, from_model, \
    gather_seq, model_group, norm_apply, param, seq_param, seq_sharded, \
    seq_splits, split_seq, to_model, trunc_normal
from repro_torch.models.mlp import MLP, mlp_apply
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.remat import remat_group


def _dtype(cfg: ModelCfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


NORMS = ("rmsnorm", "layernorm")


def _norm_params(module: nn.Module, name: str, kind: str, d: int, device,
                 dtype) -> None:
    """The norm ``name`` of ``kind`` on ``module``: its zero-initialised
    (1 + scale) scale, and — a LayerNorm — its zero bias ``<name>_bias``
    (None for an RMSNorm, so every block answers the same names)."""
    param(module, name, torch.zeros(d, device=device, dtype=dtype),
          ("embed_norm",))
    if kind == "layernorm":
        param(module, name + "_bias", torch.zeros(d, device=device,
                                                  dtype=dtype),
              ("embed_norm",))
    else:
        module.register_parameter(name + "_bias", None)


class Block(nn.Module):
    """One block: a sequence mixer — attention, the RG-LRU or an RWKV-6
    time mix — and an MLP or a MoE channel mixer (an RWKV block's channel
    mix is its own), plus, in an encoder-decoder config's decoder, cross
    attention between the two (``ln1``/``ln2``/``lnx`` are the (1 + scale)
    norm scales before each, ``ln1_bias``/``ln2_bias``/``lnx_bias`` their
    biases in a LayerNorm block)."""

    def __init__(self, b: BlockCfg, d: int, *, generator, device,
                 dtype=torch.float32):
        super().__init__()
        mixers = sum(m is not None for m in (b.attn, b.rglru, b.rwkv))
        channel = sum(m is not None for m in (b.mlp, b.moe))
        if (mixers != 1 or channel != (0 if b.rwkv is not None else 1)
                or (b.cross_attn is not None and b.attn is None)
                or b.norm not in NORMS or b.post_norm):
            raise NotImplementedError(
                "the port runs attention, RG-LRU or RWKV blocks (attention "
                "with an MLP or a MoE, and optional cross attention) behind "
                "RMSNorm or LayerNorm only; other block kinds are not "
                "ported (see ROADMAP.md)")
        self.bcfg = b
        kw = dict(generator=generator, device=device, dtype=dtype)
        _norm_params(self, "ln1", b.norm, d, device, dtype)
        if b.attn is not None:
            self.attn = attn.Attention(b.attn, d, **kw)
        elif b.rglru is not None:
            self.rglru = rgm.RGLRU(b.rglru, d, **kw)
        else:
            self.rwkv = rkm.RWKV(b.rwkv, d, **kw)
        if b.cross_attn is not None:
            _norm_params(self, "lnx", b.norm, d, device, dtype)
            self.cross = attn.Attention(b.cross_attn, d, **kw)
        _norm_params(self, "ln2", b.norm, d, device, dtype)
        if b.moe is not None:
            self.moe = MoE(b.moe, d, **kw)
        elif b.mlp is not None:
            self.mlp = MLP(b.mlp, d, **kw)

    def forward(self, cfg: ModelCfg, x, **kw):
        """``_block_apply`` (what ``torch.func.functional_call`` runs on
        a train step's copies of the block's tensors)."""
        return _block_apply(self, cfg, x, **kw)


def block_norm(bp: Block, which, x, eps: float):
    """The block's norm before its sequence mixer (``which`` 1), its
    channel mixer (2) or its cross attention ("x"), of the block's kind
    (on a sequence shard its scale and bias pass ``seq_param``)."""
    return norm_apply(bp.bcfg.norm, seq_param(getattr(bp, f"ln{which}")), x,
                      bias=seq_param(getattr(bp, f"ln{which}_bias")),
                      eps=eps)


def final_norm(params, cfg: ModelCfg, x):
    """The final norm, of the first block's kind (the reference's
    ``cfg.segments[0].blocks[0].norm``; ``seq_param`` as ``block_norm``)."""
    return norm_apply(cfg.segments[0].blocks[0].norm,
                      seq_param(params.final_norm), x,
                      bias=seq_param(params.final_norm_bias),
                      eps=cfg.norm_eps)


def channel_mix(bp: Block, x, aux: list | None = None):
    """The block's MLP, or its MoE. A MoE appends its router's aux loss
    to ``aux`` when given (training); without it the aux is not computed
    (serving)."""
    if bp.bcfg.moe is not None:
        y, a = moe_apply(bp.moe, x, with_aux=aux is not None)
        if aux is not None:
            aux.append(a)
        return y
    return mlp_apply(bp.mlp, x)


class Encoder(nn.Module):
    """The auxiliary bidirectional encoder (whisper's audio encoder): its
    blocks at the encoder's width, the final LayerNorm (``final_norm``,
    ``final_norm_bias``) and — when the widths differ — ``proj`` (d_enc,
    d) into the decoder's width."""

    def __init__(self, enc, d: int, *, generator, device,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        de = enc.d_model
        self.blocks = nn.ModuleList(
            Block(b, de, **kw) for seg in enc.segments
            for b in (seg.blocks[j % len(seg.blocks)]
                      for j in range(seg.n_layers)))
        _norm_params(self, "final_norm", "layernorm", de, device, dtype)
        if de != d:
            param(self, "proj", dense_init((de, d), **kw), ("stub", "embed"))


class Transformer(nn.Module):
    def __init__(self, cfg: ModelCfg, *, generator: torch.Generator, device,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(generator=generator, device=device, dtype=dtype)
        param(self, "embed", embed_init(cfg.vocab, d, **kw),
              ("vocab", "embed"))
        _norm_params(self, "final_norm", cfg.segments[0].blocks[0].norm, d,
                     device, dtype)
        self.blocks = nn.ModuleList(
            Block(b, d, **kw) for b in layer_blocks(cfg))
        if not cfg.tie_embeddings:
            param(self, "lm_head", dense_init((d, cfg.vocab), **kw),
                  ("embed", "vocab"))
        if cfg.learned_pos_len:
            param(self, "pos_embed", dense_init(
                (cfg.learned_pos_len, d), scale=0.02, **kw),
                ("seq_table", "embed"))
        if cfg.encoder is not None:
            self.encoder = Encoder(cfg.encoder, d, **kw)
        if cfg.soi is not None:
            st = cfg.soi.stride
            # S-CC compress conv (kernel = stride) + identity-biased fusion
            param(self, "soi_compress", dense_init(
                (st, d, d), scale=(st * d) ** -0.5, **kw),
                ("conv_k", "embed", "embed_act"))
            wf_new = trunc_normal((d, d), generator, device=device,
                                  scale=0.02)
            eye = torch.eye(d, device=device)
            param(self, "soi_fuse", torch.cat([wf_new, eye], dim=0).to(dtype),
                  ("stub", "embed"))

    def forward(self, tokens, aux: list | None = None, *,
                prefix_embeds=None, encoder_frames=None, leaves=None):
        """The final-norm hidden states (B, P + S, d) of ``tokens`` after
        ``prefix_embeds`` (B, P, d) when given, reading the encoder's
        output over ``encoder_frames`` (B, n_frames, d_enc) in an
        encoder-decoder config (what ``loss_fn`` runs through
        ``torch.func.functional_call``, so the encoder runs on the same
        cast copies and its gradients reach its masters); every MoE layer
        appends its aux loss to ``aux`` when given. The blocks run on
        ``leaves`` (``BlockLeaves``) when given."""
        enc_out = (None if encoder_frames is None
                   else encoder_trunk(self, self.cfg, encoder_frames,
                                      leaves=leaves))
        return trunk(self, self.cfg, tokens, prefix_embeds=prefix_embeds,
                     enc_out=enc_out, aux=aux, leaves=leaves)


def layer_blocks(cfg: ModelCfg) -> list:
    """The BlockCfg of every layer, in order."""
    out = []
    for seg in cfg.segments:
        out += [seg.blocks[j % len(seg.blocks)] for j in range(seg.n_layers)]
    return out


def init(cfg: ModelCfg, *, generator: torch.Generator, device=None,
         dtype=torch.float32) -> Transformer:
    """Random weights from ``generator`` with the reference's distributions
    (``repro.models.transformer.init``), as float32 masters unless
    ``dtype`` says otherwise."""
    from repro_torch import resolve_device
    return Transformer(cfg, generator=generator,
                       device=resolve_device(device), dtype=dtype)


def cast_params(params: Transformer, cfg: ModelCfg) -> Transformer:
    """Mixed precision: cast float32 masters to the compute dtype, in place
    (a no-op once cast)."""
    dt = _dtype(cfg)
    if params.embed.dtype != dt:
        params.to(dt)
    return params


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _block_apply(bp: Block, cfg: ModelCfg, x, *, positions, prefix_len=0,
                 enc_out=None, fill_cache=None, fill_true_length=None,
                 aux=None):
    """Full-sequence block. Returns (x, cache_out): the filled attention
    cache (None without ``fill_cache``), an RG-LRU block's recurrence state,
    or an RWKV block's time- and channel-mix states (``{"rwkv_tm":
    {"x_prev", "S"}, "rwkv_cm"}``). A cross block reads ``enc_out``; a MoE
    block appends its aux loss to ``aux`` when given."""
    eps = cfg.norm_eps
    b = bp.bcfg
    h = block_norm(bp, 1, x, eps)
    if b.rwkv is not None:
        h, (x_last, S) = rkm.rwkv_time_mix(bp.rwkv, h)
        x = x + h
        h2, x_last2 = rkm.rwkv_channel_mix(bp.rwkv, block_norm(bp, 2, x, eps))
        return x + h2, {"rwkv_tm": {"x_prev": x_last, "S": S},
                        "rwkv_cm": x_last2}
    if b.rglru is not None:
        h, cache = rgm.rglru_forward(bp.rglru, h)
    else:
        h, cache = attn.attn_forward(bp.attn, h, positions=positions,
                                     prefix_len=prefix_len, norm_eps=eps,
                                     fill_cache=fill_cache,
                                     fill_true_length=fill_true_length)
    x = x + h
    if b.cross_attn is not None:
        h, _ = attn.attn_forward(bp.cross, block_norm(bp, "x", x, eps),
                                 positions=positions, norm_eps=eps,
                                 kv_x=enc_out)
        x = x + h
    h = block_norm(bp, 2, x, eps)
    return x + channel_mix(bp, h, aux), cache


class BlockLeaves:
    """A train step's tensors of the blocks (``loss_sums``): ``raw(bp)``
    the block's tensors as the step holds them (float32 masters, or a
    rank's shards), ``ready(bp, raw)`` those in the compute dtype, an
    fsdp step's data-split leaves gathered whole (``ready(name, tensor)``
    of each). ``_segment_forward`` makes the ready copies inside the
    block's layer group, so they live while the group runs and the
    backward's recompute of a rematerialised group makes them again."""

    def __init__(self, params: nn.Module, tensors: dict, ready):
        self.names = {bp: {k: f"{prefix}.{k}"
                           for k, _ in bp.named_parameters()}
                      for prefix, bp in params.named_modules()
                      if isinstance(bp, Block)}
        self.tensors = tensors
        self._ready = ready

    def full_names(self) -> set:
        """The qualified names of every block's tensors."""
        return {n for names in self.names.values() for n in names.values()}

    def raw(self, bp: Block) -> dict:
        return {k: self.tensors[n] for k, n in self.names[bp].items()}

    def ready(self, bp: Block, raw: dict) -> dict:
        return {k: self._ready(n, raw[k]) for k, n in self.names[bp].items()}


def layer_groups(blocks, segments) -> list:
    """``(scanned, [blocks])`` of each layer group of ``blocks`` (the
    layers of ``segments``), in order: a scanned segment's groups of
    ``len(seg.blocks)`` layers (the reference's scan body, the unit it
    rematerialises), an unscanned segment's layers one by one."""
    blocks = list(blocks)
    out, i = [], 0
    for seg in segments:
        g = len(seg.blocks) if seg.scan else 1
        out += [(seg.scan, blocks[j:j + g])
                for j in range(i, i + seg.n_layers, g)]
        i += seg.n_layers
    if i != len(blocks):
        raise ValueError(f"segments of {i} layers over {len(blocks)} blocks")
    return out


def _group_apply(group, cfg: ModelCfg, kw: dict, leaves, keys, want_aux,
                 x, *flat):
    """One layer group's blocks in order, each on ``leaves``' ready
    copies of its raw tensors (``flat``, the names of each block's in
    ``keys``) when given, else on its own parameters. Returns (x, the MoE
    blocks' aux losses in order when ``want_aux``)."""
    it = iter(flat)
    terms = [] if want_aux else None
    for bp, names in zip(group, keys):
        raw = {k: next(it) for k in names}
        if leaves is None:
            x, _ = _block_apply(bp, cfg, x, aux=terms, **kw)
        else:
            x, _ = torch.func.functional_call(
                bp, leaves.ready(bp, raw), (cfg, x), dict(kw, aux=terms))
    return (x, *(terms or ()))


def _segment_prefill(blocks, cfg: ModelCfg, x, *, positions, batch,
                     max_len, true_length=None, prefix_len=0, enc_out=None,
                     aux=None):
    """Apply a run of layers in a prefill. Returns (x, caches), one cache
    dict per layer: an attention layer's filled ring, an RG-LRU or RWKV
    layer's recurrence state. Each MoE layer appends its aux loss to
    ``aux`` when given, in layer order. No checkpoint: a prefill runs
    without grad."""
    caches = []
    for bp in blocks:
        fill = None
        if bp.bcfg.attn is not None:
            fill = attn.init_cache(bp.bcfg.attn, batch, max_len, x.dtype,
                                   x.device)
        x, c = _block_apply(bp, cfg, x, positions=positions,
                            prefix_len=prefix_len, enc_out=enc_out,
                            fill_cache=fill, fill_true_length=true_length,
                            aux=aux)
        caches.append(c)
    return x, caches


def _segment_forward(blocks, cfg: ModelCfg, x, *, positions, segments,
                     leaves=None, prefix_len=0, enc_out=None, aux=None):
    """Apply a run of layers — those of ``segments`` — group by group
    (``layer_groups``). Returns (x, []). Each block runs on ``leaves``'
    ready copies of its tensors when given (a train step:
    ``BlockLeaves``), made inside its group. Each MoE layer appends its
    aux loss to ``aux`` when given, in layer order.

    With grad enabled and ``cfg.remat``, each group of a scanned segment
    runs under ``remat.remat_group`` with ``cfg.remat_policy``, as the
    reference's scan body runs under ``jax.checkpoint``; unscanned layers,
    and every run without grad (serving, the captured graphs), see no
    checkpoint."""
    kw = dict(positions=positions, prefix_len=prefix_len, enc_out=enc_out)
    remat = cfg.remat and torch.is_grad_enabled()
    for scanned, group in layer_groups(blocks, segments):
        raw = [{} if leaves is None else leaves.raw(bp) for bp in group]
        run = functools.partial(_group_apply, group, cfg, kw, leaves,
                                [list(r) for r in raw], aux is not None)
        flat = [t for r in raw for t in r.values()]
        out = (remat_group(run, cfg.remat_policy, x, *flat)
               if remat and scanned else run(x, *flat))
        x = out[0]
        if aux is not None:
            aux.extend(out[1:])
    return x, []


# ---------------------------------------------------------------------------
# SOI segment partitioning
# ---------------------------------------------------------------------------

def soi_partition(cfg: ModelCfg):
    """Split cfg.segments into (pre, mid, post) segment lists at the SOI
    boundaries. Boundaries must align with block-pattern groups."""
    soi = cfg.soi
    pre, mid, post = [], [], []
    idx = 0
    for seg in cfg.segments:
        glen = len(seg.blocks)
        for part, lo, hi in (("pre", 0, soi.first_layer),
                             ("mid", soi.first_layer, soi.last_layer),
                             ("post", soi.last_layer, cfg.n_layers)):
            a = max(idx, lo)
            b = min(idx + seg.n_layers, hi)
            if b > a:
                if (a - idx) % glen or (b - a) % glen:
                    raise ValueError("SOI boundary must align with the "
                                     "segment block pattern")
                sub = dataclasses.replace(seg, n_layers=b - a)
                {"pre": pre, "mid": mid, "post": post}[part].append(sub)
        idx += seg.n_layers
    return pre, mid, post


def split_blocks(params: Transformer, cfg: ModelCfg):
    """The (pre, mid, post) layer lists at the SOI boundaries (the port's
    counterpart of slicing stacked segment params)."""
    blocks = list(params.blocks)
    out, i = [], 0
    for part in soi_partition(cfg):
        n = sum(seg.n_layers for seg in part)
        out.append(blocks[i:i + n])
        i += n
    return tuple(out)


def soi_compress(params: Transformer, soi: SOILMCfg, x):
    """S-CC compress: width-`stride` stride-`stride` *causal* conv over time
    — frame s sees tokens <= s*stride; any length S yields ceil(S/stride)
    frames."""
    return causal_conv1d(x, params.soi_compress.to(x.dtype),
                         stride=soi.stride)


def soi_extrapolate(soi: SOILMCfg, xc, out_len: int):
    up = torch.repeat_interleave(xc, soi.stride, dim=1)[:, :out_len]
    if soi.mode == "fp":
        up = torch.cat([torch.zeros_like(up[:, :1]), up[:, :-1]], dim=1)
    return up


def soi_fuse(params: Transformer, xu, skip):
    cat = torch.cat([xu, skip], dim=-1)
    return torch.matmul(cat, params.soi_fuse.to(cat.dtype))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_tokens(params: Transformer, cfg: ModelCfg, tokens,
                  positions=None, split: bool = False):
    """tokens (B, S) -> (B, S, d) in the compute dtype; gemma configs
    (``embed_scale``) multiply by sqrt(d), cast to that dtype first; a
    learned position table adds its rows 0..S-1, or the rows of
    ``positions`` ((S,) or (B, S) absolute positions) when given. The
    lookup is ``F.embedding``, whose CUDA backward sums a row's repeats
    in a fixed order (``index_select``'s adds them with atomics), so a
    train step repeats bit for bit. A vocab split over the model axis
    (``layers.model_parallel``) looks up the shard's rows only, zero for
    the others, and sums over the model axis. With ``split`` (sequence
    parallelism) the result is this model rank's rows (B, S/M, d): the
    vocab-split sum a reduce-scatter onto them, and the position table's
    rows those of the rank's positions."""
    if params.embed.shape[0] != cfg.vocab:
        x = _vocab_parallel_embed(params.embed, tokens, split).to(
            _dtype(cfg))
    else:
        x = F.embedding(tokens.long(), params.embed).to(_dtype(cfg))
        if split:
            x = split_seq(x)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.learned_pos_len:
        pe = (params.pos_embed[:tokens.shape[1]] if positions is None
              else F.embedding(positions.long(), params.pos_embed))
        if split:                       # the table's rows of the rank's
            pe = split_seq(pe[None])    # positions, all-gather backward
        x = x + pe.to(x.dtype)
    return x


def _vocab_range(group, v_loc: int) -> int:
    """The first vocab row of this rank's shard of ``v_loc`` rows."""
    return dist.get_rank(group) * v_loc


def _vocab_parallel_embed(embed, tokens, split: bool = False):
    """Masked local lookup of a vocab-split table, then the sum over the
    model axis (one shard holds each token's row): with ``split`` onto
    this rank's rows of the sequence."""
    group = model_group()
    if group is None:
        raise RuntimeError("a vocab-split embedding needs "
                           "layers.model_parallel(group)")
    v_loc = embed.shape[0]
    t = tokens.long() - _vocab_range(group, v_loc)
    inside = (t >= 0) & (t < v_loc)
    x = F.embedding(torch.clamp(t, 0, v_loc - 1), embed)
    x = x * inside[..., None].to(x.dtype)
    if split:
        return coll.scatter_seq_from_model(x, 1, group)
    return from_model(x)


@torch.no_grad()
def encode(params: Transformer, cfg: ModelCfg, frames):
    """Serving's audio encoder over stub frontend frames (B, n_frames,
    d_enc), on the module cast in place to the compute dtype
    (``cast_params``). Returns (B, n_frames, d) in the compute dtype."""
    return encoder_trunk(cast_params(params, cfg), cfg, frames)


def encoder_trunk(params: Transformer, cfg: ModelCfg, frames, leaves=None):
    """The audio encoder on ``params`` as they are (training runs it on
    the cast copies of ``loss_sums``, its blocks on ``leaves``):
    bidirectional blocks, the final LayerNorm and the projection into the
    decoder's width. Returns (B, n_frames, d) in the compute dtype."""
    enc = params.encoder
    x = frames.to(_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, _ = _segment_forward(enc.blocks, cfg, x, positions=positions,
                            segments=cfg.encoder.segments, leaves=leaves)
    x = norm_apply("layernorm", enc.final_norm, x, bias=enc.final_norm_bias,
                   eps=cfg.norm_eps)
    if hasattr(enc, "proj"):
        x = torch.matmul(x, enc.proj)
    return x


def embed_inputs(params: Transformer, cfg: ModelCfg, tokens,
                 prefix_embeds=None):
    """(x, split) of the trunk's input: the token embeddings after
    ``prefix_embeds`` (B, P, d) when given, and whether the carry splits
    on its sequence over the model axis (``layers.seq_splits``) — x then
    the rank's rows."""
    s = tokens.shape[1] + (0 if prefix_embeds is None
                           else prefix_embeds.shape[1])
    split = seq_splits(s)
    x = _embed_tokens(params, cfg, tokens,
                      split=split and prefix_embeds is None)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        if split:
            x = split_seq(x)
    return x, split


def seq_forward(blocks, cfg: ModelCfg, x, split: bool, *,
                collect_cache=False, **kw):
    """``_segment_forward`` (``_segment_prefill`` with ``collect_cache``)
    on a carry that is the rank's rows where ``split``
    (``layers.seq_sharded``), else whole."""
    with seq_sharded(split):
        return (_segment_prefill if collect_cache
                else _segment_forward)(blocks, cfg, x, **kw)


def whole_forward(blocks, cfg: ModelCfg, x, **kw):
    """``_segment_forward`` from and to a whole carry (the SOI middle):
    split on its sequence over the model axis for the blocks where
    ``layers.seq_splits`` says so."""
    split = seq_splits(x.shape[1])
    x, caches = seq_forward(blocks, cfg, split_seq(x) if split else x,
                            split, **kw)
    return (gather_seq(x) if split else x), caches


def trunk(params: Transformer, cfg: ModelCfg, tokens, *, prefix_embeds=None,
          enc_out=None, aux: list | None = None, leaves=None):
    """Token embeddings (after ``prefix_embeds`` (B, P, d), when given) ->
    final norm hidden states (B, P + S, d); cross blocks read ``enc_out``.
    A prefix-LM config's first ``frontend_len`` positions attend
    bidirectionally (outside the SOI middle, as in the reference). With
    ``aux`` (a list) every MoE layer appends its router's aux loss, the
    compressed middle's included, in the reference's order (pre, middle,
    post). Under ``layers.sequence_parallel`` the carry between blocks is
    the rank's rows where the model axis divides its length, gathered
    whole around SOI's compress, extrapolation and fusion and at the
    end. The blocks run on ``leaves`` (``BlockLeaves``) when given, in
    layer groups rematerialised with ``cfg.remat`` (``_segment_forward``).
    """
    x, split = embed_inputs(params, cfg, tokens, prefix_embeds)
    s = tokens.shape[1] + (0 if prefix_embeds is None
                           else prefix_embeds.shape[1])
    positions = torch.arange(s, device=x.device)[None]
    if enc_out is not None:
        # every cross layer projects the rank's heads of it: one sum over
        # the model axis of all their gradients
        enc_out = to_model(enc_out)
    kw = dict(prefix_len=cfg.frontend_len if cfg.prefix_lm else 0,
              enc_out=enc_out, aux=aux, leaves=leaves)
    if cfg.soi is None:
        x, _ = seq_forward(params.blocks, cfg, x, split,
                           positions=positions, segments=cfg.segments, **kw)
    else:
        soi = cfg.soi
        pre, mid, post = split_blocks(params, cfg)
        pre_s, mid_s, post_s = soi_partition(cfg)
        x, _ = seq_forward(pre, cfg, x, split, positions=positions,
                           segments=pre_s, **kw)
        skip = x = gather_seq(x) if split else x
        xc = soi_compress(params, soi, x)
        cpos = torch.arange(xc.shape[1], device=x.device)[None]
        xc, _ = whole_forward(mid, cfg, xc, positions=cpos, segments=mid_s,
                              enc_out=enc_out, aux=aux, leaves=leaves)
        x = soi_fuse(params, soi_extrapolate(soi, xc, s), skip)
        x, _ = seq_forward(post, cfg, split_seq(x) if split else x, split,
                           positions=positions, segments=post_s, **kw)
    with seq_sharded(split):
        x = final_norm(params, cfg, x)
    return gather_seq(x) if split else x


def _head_weights(params: Transformer):
    if params.cfg.tie_embeddings:
        return params.embed.t()
    return params.lm_head


def _softcap(logits, cap):
    """``cap * tanh(logits / cap)``, or the logits without a cap."""
    if cap:
        return cap * torch.tanh(logits / cap)
    return logits


def softcap_logits(cfg: ModelCfg, logits):
    """``cap * tanh(logits / cap)`` on float32 logits of configs with a
    ``logits_softcap`` (gemma); the logits unchanged otherwise."""
    return _softcap(logits, cfg.logits_softcap)


@torch.no_grad()
def forward(params: Transformer, cfg: ModelCfg, tokens, *,
            prefix_embeds=None, enc_out=None):
    """Full logits (B, P + S, V) in float32 (small inputs only — tests)."""
    params = cast_params(params, cfg)
    h = trunk(params, cfg, tokens, prefix_embeds=prefix_embeds,
              enc_out=enc_out)
    return softcap_logits(cfg, torch.matmul(h, _head_weights(params)).float())


# ---------------------------------------------------------------------------
# Loss (training)
# ---------------------------------------------------------------------------

def check_trainable(cfg: ModelCfg, device) -> None:
    """Raise for what the port's training does not run on ``device``.
    Every block and model kind trains (attention — GQA, windowed, MLA,
    bidirectional and cross —, the RG-LRU and RWKV-6, MLPs and MoE, RMSNorm
    and LayerNorm, the encoder-decoder and the prefix-LM); on the card an
    attention ``logit_softcap`` outside a window is refused: the CUDA flash
    backward takes no cap (ROADMAP.md Queue 1 item 7)."""
    if torch.device(device).type != "cuda":
        return
    for b in layer_blocks(cfg) + (
            [] if cfg.encoder is None else
            [b for seg in cfg.encoder.segments for b in seg.blocks]):
        for a in (b.attn, b.cross_attn):
            if a is not None and a.logit_softcap and a.window is None:
                raise NotImplementedError(
                    f"config '{cfg.name}': an attention logit_softcap in "
                    f"the flash_attention backward on the card is queued "
                    f"in ROADMAP.md (Queue 1 item 7)")


def _xent_chunk(hb, head_w, tb, softcap, group=None):
    """(summed masked NLL, count of targets >= 0) of one sequence chunk.
    With ``group`` the head's vocab columns are split over it: the max,
    the sum of exps and the target logit are each reduced over the model
    axis (the max without a gradient: the log-sum-exp does not depend on
    it)."""
    if group is not None:
        hb = coll.copy_to_model(hb, group)
    logits = _softcap(torch.matmul(hb, head_w).float(), softcap)
    mask = (tb >= 0).float()
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          torch.clamp(tb, min=0).long()[..., None])[..., 0]
        return torch.sum((lse - ll) * mask), torch.sum(mask)
    v_loc = logits.shape[-1]
    mx = torch.amax(logits.detach(), dim=-1)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    se = torch.sum(torch.exp(logits - mx[..., None]), dim=-1)
    lse = mx + torch.log(coll.reduce_from_model(se, group))
    t = tb.long() - _vocab_range(group, v_loc)
    inside = (t >= 0) & (t < v_loc)
    ll = torch.gather(logits, -1, torch.clamp(t, 0, v_loc - 1)[..., None])
    ll = coll.reduce_from_model(ll[..., 0] * inside.float(), group)
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def xent_sums(h, head_w, targets, *, softcap=None, chunk=256, group=None):
    """Memory-sane cross entropy (``repro.models.transformer.chunked_xent``)
    as its two sums: (summed masked NLL, count of targets >= 0), which a
    data-parallel step reduces over its data axes before it divides.
    Sequence chunks of ``chunk`` positions, each under
    ``torch.utils.checkpoint`` as the reference's ``jax.checkpoint``'d scan
    body, so the (B, S, V) logits never stand whole — the backward
    recomputes one chunk's logits at a time. Targets of -1 are masked.
    ``group``: the model axis the head's vocab is split over, or None."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s + pad, chunk):
        n, c = checkpoint(_xent_chunk, h[:, c0:c0 + chunk], head_w,
                          targets[:, c0:c0 + chunk], softcap, group,
                          use_reentrant=False)
        nll = nll + n
        count = count + c
    return nll, count


def loss_sums(params: Transformer, cfg: ModelCfg, batch: dict,
              tensors: dict | None = None, aux: list | None = None,
              gather: dict | None = None):
    """(summed masked NLL, count of targets >= 0) of ``batch``, the parts
    of ``loss_fn``'s mean. ``tensors`` ({name: tensor}, default the
    module's parameters) are what the model runs on: a sharded step passes
    its local shards, inside ``layers.model_parallel``; where the vocab is
    split the head's cross entropy reduces over the model axis. With
    ``aux`` (a list) every MoE layer appends its router's aux loss, which
    ``loss_fn`` adds outside the mean. The batch's optional stubs, as the
    reference's ``loss_fn`` reads them: ``patch_embeds`` (B, P, d) go
    ahead of the token embeddings and their P positions are dropped before
    the cross entropy (the prefix-LM); an encoder-decoder config's
    encoder runs over ``encoder_frames`` (B, n_frames, d_enc) inside the
    same differentiated call.

    Mixed precision as in the reference: every float32 master is cast to
    the compute dtype *inside* the differentiated function — the model runs
    on the cast copies through ``torch.func.functional_call`` — so the
    gradients reach the float32 masters in float32, and the module itself
    is not cast (unlike serving's in-place ``cast_params``). ``gather``
    ({name: fn(tensor, dtype=...)}) replaces the cast of those leaves: an fsdp
    step's ``collectives.gather_from_data``, which casts the rank's shard
    and gathers the whole leaf (so the gathered copy is in the compute
    dtype, and its gradient reaches the shard in float32).

    The leaves outside the blocks (the embedding, the head, the final
    norm, SOI's compress and fuse, the encoder's norm and projection) are
    cast and gathered here, once. Each block's are cast and gathered
    inside its layer group (``BlockLeaves``): with ``cfg.remat`` a
    rematerialised group frees them when it returns and gathers them
    again when the backward recomputes it, and its gradient comes back
    through the gather's backward (summed over the data axes, the rank's
    slice kept) before the group before it runs its backward; without
    remat they stay saved for the group's backward."""
    dt = _dtype(cfg)
    if (cfg.remat, cfg.remat_policy) != (params.cfg.remat,
                                         params.cfg.remat_policy):
        # the trunk runs on the model's cfg: build the model from this one
        raise ValueError(
            f"the step's remat {cfg.remat}/{cfg.remat_policy!r} is not the "
            f"model's {params.cfg.remat}/{params.cfg.remat_policy!r}")
    if tensors is None:
        tensors = dict(params.named_parameters())
    check_trainable(cfg, tensors["embed"].device)
    gather = gather or {}

    def ready(name, p):
        if name in gather:
            return gather[name](p, dtype=dt)
        return p.to(dt) if p.dtype == torch.float32 else p
    leaves = BlockLeaves(params, tensors, ready)
    inner = leaves.full_names()
    cast = {name: ready(name, p) for name, p in tensors.items()
            if name not in inner}
    prefix = batch.get("patch_embeds")
    kw = {"aux": aux, "prefix_embeds": prefix, "leaves": leaves}
    if cfg.encoder is not None:
        kw["encoder_frames"] = batch["encoder_frames"]
    h = torch.func.functional_call(params, cast, (batch["tokens"],), kw)
    if prefix is not None:          # the loss is over the token positions
        h = h[:, prefix.shape[1]:]
    head_w = cast["embed"].t() if cfg.tie_embeddings else cast["lm_head"]
    return xent_sums(h, head_w, batch["targets"], softcap=cfg.logits_softcap,
                     group=model_group() if head_w.shape[1] != cfg.vocab
                     else None)


def loss_fn(params: Transformer, cfg: ModelCfg, batch: dict):
    """batch: tokens (B, S), targets (B, S) [-1 = masked], optional
    ``patch_embeds`` / ``encoder_frames`` stubs (``loss_sums``). Returns
    (xent + aux, {"xent", "aux"}), differentiable with respect to ``params`` (cast
    to the compute dtype inside, see ``loss_sums``): the masked mean cross
    entropy and the MoE routers' load-balancing losses summed in float32
    over every MoE layer, the SOI middle's included (0 without MoE), as
    the reference's ``loss_fn`` returns them."""
    terms = []
    nll, count = loss_sums(params, cfg, batch, aux=terms)
    xent = nll / torch.clamp(count, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=xent.device)
    for a in terms:
        aux = aux + a
    return xent + aux, {"xent": xent, "aux": aux}
