"""Causal streaming U-Net for speech separation, the paper's own testbed
(port of ``repro.models.unet``).

7 encoder + 7 decoder causal conv layers (STMC + BatchNorm + ELU). Decoder
layer j mirrors encoder layer ``m = n-j+1``; the skip carries the *input*
of encoder layer m and is concatenated with the *output* of decoder layer
j. An S-CC pair at encoder position p therefore compresses encoder p..n
and decoder 1..(n-p+1), and the extrapolation restores full rate right
after decoder layer n-p+1, where the fresh skip is injected.

Execution modes (held to each other and to the reference by the tests):
  * ``apply_offline``       — the full-sequence causal graph;
  * ``make_phase_steppers`` — one step function per SOI phase, the paper's
        *inference pattern*: phase t mod P recomputes only the layers whose
        compression windows are complete, everything else reuses cached
        partial states (conv ring buffers, extrapolation queues), written
        in place. Every computed conv is one ``stmc_step_``, i.e. one
        ``ops.stmc_conv``;
  * ``stream_infer``        — a sequence through
        ``engine.session.unet_stream_session``, frame by frame.

The parameters live in a ``UNet`` module (``enc``/``dec`` lists of conv +
norm layers, ``proj``, and ``up`` — the transposed-conv extrapolators of
tconv configs, keyed by the pair position as a string); the norms' running
mean and variance are its buffers. The norm is applied whatever
``cfg.norm`` says, as in the reference, which never reads it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import complexity as cx
from repro_torch.core.soi import SOIConvCfg, sc_shift, scc_extrapolate
from repro_torch.core.stmc import (causal_conv1d, conv_init, stmc_init_state,
                                   stmc_push_, stmc_step_)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 64
    out_channels: int = 64
    enc_channels: tuple = (32, 48, 64, 96, 128, 192, 256)
    kernel: int = 3
    norm: str = "batch"              # not read: the norm always applies
    soi: SOIConvCfg | None = None
    fps: float = 62.5                # 16 kHz / 256-sample hop
    mask_output: bool = True         # sigmoid mask head (speech separation)

    @property
    def n_enc(self) -> int:
        return len(self.enc_channels)

    @property
    def n_dec(self) -> int:
        return len(self.enc_channels)

    @property
    def period(self) -> int:
        if self.soi is None or not self.soi.pairs:
            return 1
        return self.soi.stride ** len(self.soi.pairs)

    @property
    def pairs(self) -> tuple:
        return tuple(sorted(self.soi.pairs)) if self.soi else ()


# ---------------------------------------------------------------------------
# Freshness predicates (static Python: they define each phase's graph)
# ---------------------------------------------------------------------------

def _n_pairs_le(cfg: UNetConfig, i: int) -> int:
    return sum(1 for p in cfg.pairs if p <= i)


def _n_pairs_lt(cfg: UNetConfig, i: int) -> int:
    return sum(1 for p in cfg.pairs if p < i)


def _enc_computes(cfg, i, t):     # encoder layer i runs its conv at phase t
    if cfg.soi is None:
        return True
    return t % (cfg.soi.stride ** _n_pairs_le(cfg, i)) == 0


def _enc_has_input(cfg, i, t):    # a new frame reaches encoder layer i
    if cfg.soi is None:
        return True
    return t % (cfg.soi.stride ** _n_pairs_lt(cfg, i)) == 0


def _dec_computes(cfg, j, t):
    """Decoder layer j (mirror m = n-j+1) is inside pair p's region iff
    p <= m."""
    if cfg.soi is None:
        return True
    m = cfg.n_enc - j + 1
    return t % (cfg.soi.stride ** _n_pairs_le(cfg, m)) == 0


# ---------------------------------------------------------------------------
# Parameters and norm state
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    """A causal conv: ``w (K, Cin, Cout)``, ``b (Cout,)``."""

    def __init__(self, kernel: int, cin: int, cout: int, *, generator,
                 device, dtype):
        super().__init__()
        p = conv_init(generator, kernel, cin, cout, device=device,
                      dtype=dtype)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"])


class ConvNorm(Conv):
    """A U-Net layer: the causal conv and its BatchNorm — ``scale`` and
    ``bias`` parameters, ``mean`` and ``var`` running-stat buffers."""

    def __init__(self, kernel: int, cin: int, cout: int, *, generator,
                 device, dtype):
        super().__init__(kernel, cin, cout, generator=generator,
                         device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.scale = nn.Parameter(torch.ones(cout, **kw))
        self.bias = nn.Parameter(torch.zeros(cout, **kw))
        self.register_buffer("mean", torch.zeros(cout, **kw))
        self.register_buffer("var", torch.ones(cout, **kw))


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        enc_io, dec_io = _layer_io(cfg)
        self.enc = nn.ModuleList(ConvNorm(cfg.kernel, ci, co, **kw)
                                 for ci, co in enc_io)
        self.dec = nn.ModuleList(ConvNorm(cfg.kernel, ci, co, **kw)
                                 for ci, co in dec_io)
        # the head consumes concat(decoder n output, input skip)
        self.proj = Conv(1, 2 * cfg.in_channels, cfg.out_channels, **kw)
        self.up = nn.ModuleDict()
        if cfg.soi is not None and cfg.soi.extrapolation == "tconv":
            ch = [cfg.in_channels] + list(cfg.enc_channels)
            for p in cfg.pairs:
                # the stream at pair p's extrapolation point = the output
                # of decoder layer n-p+1 = ch[p-1] channels
                self.up[str(p)] = Conv(cfg.soi.stride, ch[p - 1], ch[p - 1],
                                       **kw)


def _norm_apply(lp: ConvNorm, x: torch.Tensor, train: bool):
    """BatchNorm over all leading axes; eval mode (the running stats) in
    the stream. Returns (y, new {"mean", "var"})."""
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = x.var(axes, correction=0)
        new_s = {"mean": 0.9 * lp.mean + 0.1 * mean,
                 "var": 0.9 * lp.var + 0.1 * var}
    else:
        mean, var = lp.mean, lp.var
        new_s = {"mean": mean, "var": var}
    y = (x - mean) * torch.rsqrt(var + 1e-5) * lp.scale + lp.bias
    return y, new_s


def _layer_io(cfg: UNetConfig) -> tuple[list, list]:
    """(cin, cout) per layer. ch[i] = input width of encoder layer i+1;
    decoder j outputs ch[n-j] and takes the bottleneck (j = 1) or
    concat(decoder j-1 output, skip) = 2 * ch[n-j+1]."""
    n = cfg.n_enc
    ch = [cfg.in_channels] + list(cfg.enc_channels)
    enc_io = [(ch[i], ch[i + 1]) for i in range(n)]
    dec_io = []
    for j in range(1, n + 1):
        cin = ch[n] if j == 1 else 2 * ch[n - j + 1]
        dec_io.append((cin, ch[n - j]))
    return enc_io, dec_io


def init(cfg: UNetConfig, *, generator: torch.Generator, device=None,
         dtype=torch.float32) -> UNet:
    """Random weights from ``generator`` (on ``device``) with the
    reference's distributions; the card unless ``device`` says otherwise."""
    return UNet(cfg, generator=generator, device=resolve_device(device),
                dtype=dtype)


def _up_frames(model: UNet, cfg: UNetConfig, p: int, h: torch.Tensor):
    """Extrapolate one compressed frame to ``stride`` full-rate frames."""
    s = cfg.soi.stride
    if cfg.soi.extrapolation != "tconv" or str(p) not in model.up:
        return tuple(h for _ in range(s))
    up = model.up[str(p)]
    return tuple(torch.einsum("bc,co->bo", h, up.w[k]) + up.b
                 for k in range(s))


# ---------------------------------------------------------------------------
# Offline (reference) graph
# ---------------------------------------------------------------------------

def apply_offline(model: UNet, x: torch.Tensor, cfg: UNetConfig, *,
                  train: bool = False):
    """Full-sequence causal forward pass of (B, T, in_channels). Returns
    (y, new norm state ``{"enc": [{"mean", "var"}], "dec": [...]}``); with
    ``train`` the norms use the batch statistics and the new state their
    running averages (the module's buffers are left as they are).
    Differentiable with respect to the model's parameters (the training
    graph, on every device: its convs are ``causal_conv1d``'s products,
    no kernel); inference callers run it under ``torch.no_grad()``."""
    soi = cfg.soi
    pairs = set(cfg.pairs)
    n = cfg.n_enc
    new_ns = {"enc": [], "dec": []}
    outermost = min(pairs) if pairs else None

    skips = [x]           # skips[i] = input of encoder layer i+1
    h = x
    for i in range(1, n + 1):
        lp = model.enc[i - 1]
        stride = soi.stride if (soi and i in pairs) else 1
        h = causal_conv1d(h, lp.w, lp.b, stride=stride)
        h, ns = _norm_apply(lp, h, train)
        new_ns["enc"].append(ns)
        h = F.elu(h)
        if soi and soi.mode == "fp" and soi.shift_pos == i:
            h = sc_shift(h, shift=1)         # hybrid: compressed-domain delay
        if i < n:
            skips.append(h)

    for j in range(1, n + 1):
        mirror = n - j + 1
        lp = model.dec[j - 1]
        h = causal_conv1d(h, lp.w, lp.b)
        h, ns = _norm_apply(lp, h, train)
        new_ns["dec"].append(ns)
        h = F.elu(h)
        if soi and mirror in pairs:
            # as in the reference: an ``up`` conv of the pair, if the
            # model has one, extrapolates here
            up = model.up[str(mirror)] if str(mirror) in model.up else None
            h = scc_extrapolate(h, stride=soi.stride,
                                out_len=skips[mirror - 1].shape[1],
                                w=None if up is None else up.w,
                                b=None if up is None else up.b)
            if (soi.mode == "fp" and soi.shift_pos is None
                    and mirror == outermost):
                h = sc_shift(h, shift=1)     # SS-CC: post-extrapolation shift
        h = torch.cat([h, skips[mirror - 1]], dim=-1)

    y = causal_conv1d(h, model.proj.w, model.proj.b)
    if cfg.mask_output:
        y = torch.sigmoid(y) * x[..., :cfg.out_channels]
    return y, new_ns


# ---------------------------------------------------------------------------
# Online inference pattern (the paper's contribution)
# ---------------------------------------------------------------------------

def init_stream_state(batch: int, cfg: UNetConfig, *, dtype=torch.float32,
                      device=None) -> dict:
    """Partial state: conv ring buffers, extrapolation queues and the
    FP-hybrid delay slot (None otherwise)."""
    dev = resolve_device(device)
    enc_io, dec_io = _layer_io(cfg)
    k = cfg.kernel
    soi = cfg.soi
    kw = dict(dtype=dtype, device=dev)
    state = {
        "enc": [stmc_init_state(batch, k, ci, **kw) for ci, _ in enc_io],
        "dec": [stmc_init_state(batch, k, ci, **kw) for ci, _ in dec_io],
        "queues": {},
        "delay": None,
    }
    if soi:
        ch = [cfg.in_channels] + list(cfg.enc_channels)
        for p in cfg.pairs:
            state["queues"][p] = torch.zeros((batch, soi.stride, ch[p - 1]),
                                             **kw)
        if soi.mode == "fp" and soi.shift_pos is not None:
            state["delay"] = torch.zeros(
                (batch, cfg.enc_channels[soi.shift_pos - 1]), **kw)
    return state


def phase_plan(cfg: UNetConfig, phase: int) -> tuple[list, list]:
    """What phase ``phase`` runs: the encoder plan ``[(layer, "compute" |
    "push")]`` — it stops at the first layer that only pushes, deeper
    layers get nothing — and the decoder layers that compute."""
    enc_plan = []
    for i in range(1, cfg.n_enc + 1):
        if _enc_computes(cfg, i, phase):
            enc_plan.append((i, "compute"))
        elif _enc_has_input(cfg, i, phase):
            enc_plan.append((i, "push"))
            break
        else:
            break
    dec_plan = [j for j in range(1, cfg.n_dec + 1)
                if _dec_computes(cfg, j, phase)]
    return enc_plan, dec_plan


def convs_per_phase(cfg: UNetConfig) -> list[int]:
    """Computed STMC convs (``stmc_conv`` launches on the card) of each
    phase's step."""
    out = []
    for t in range(cfg.period):
        enc_plan, dec_plan = phase_plan(cfg, t)
        out.append(sum(w == "compute" for _, w in enc_plan) + len(dec_plan))
    return out


def make_phase_steppers(cfg: UNetConfig) -> list:
    """One ``step(model, state, frame) -> (state, out)`` per phase. Each
    phase is a fixed graph; stale layers appear nowhere in the stale
    phases' graphs, which is how SOI realizes its MAC savings. A step runs
    under ``torch.no_grad()`` (the stream is inference: ``stmc_conv`` has
    no backward) and writes the stream state in place — the conv rings, the extrapolation
    queues, the FP delay slot — and returns the same state object, so the
    session can capture each phase as a CUDA graph over it."""
    n = cfg.n_enc
    soi = cfg.soi
    pairs = list(cfg.pairs)
    outermost = min(pairs) if pairs else None
    fp_fused = soi is not None and soi.mode == "fp" and soi.shift_pos is None
    fp_hybrid = (soi is not None and soi.mode == "fp"
                 and soi.shift_pos is not None)

    def build(phase: int):
        enc_plan, dec_list = phase_plan(cfg, phase)
        dec_plan = set(dec_list)

        @torch.no_grad()
        def step(model: UNet, state: dict, frame: torch.Tensor):
            enc, dec, queues = state["enc"], state["dec"], state["queues"]
            skips = {0: frame}    # skips[i] = input of encoder layer i+1
            h = frame
            for i, what in enc_plan:
                lp = model.enc[i - 1]
                if what == "push":
                    stmc_push_(enc[i - 1], h)
                    break
                h = stmc_step_(enc[i - 1], h, lp.w, lp.b)
                h = F.elu(_norm_apply(lp, h, train=False)[0])
                if fp_hybrid and soi.shift_pos == i:
                    # 1-compressed-frame delay: serve the held frame, hold
                    # this one
                    held = state["delay"].clone()
                    state["delay"].copy_(h)
                    h = held
                skips[i] = h

            for j in range(1, n + 1):
                mirror = n - j + 1
                if j in dec_plan:
                    lp = model.dec[j - 1]
                    h = stmc_step_(dec[j - 1], h, lp.w, lp.b)
                    h = F.elu(_norm_apply(lp, h, train=False)[0])
                if mirror in pairs:
                    q = queues[mirror]
                    producer_fresh = j in dec_plan
                    consumer_fresh = _enc_has_input(cfg, mirror, phase)
                    if fp_fused and mirror == outermost:
                        # FP: serve from the queue (strictly-past data),
                        # then refill it with the newly predicted frames
                        if producer_fresh:
                            h_out = q[:, 0].clone()
                            q.copy_(torch.stack(
                                _up_frames(model, cfg, mirror, h), dim=1))
                        else:
                            rolled = torch.roll(q, -1, dims=1)
                            h_out = rolled[:, -1]      # q's old head
                            q.copy_(rolled)
                        h = h_out
                    elif producer_fresh:
                        frames = _up_frames(model, cfg, mirror, h)
                        h = frames[0]
                        q.copy_(torch.stack(frames[1:] + (frames[-1],),
                                            dim=1))
                    elif consumer_fresh:
                        rolled = torch.roll(q, -1, dims=1)
                        h = rolled[:, -1]              # q's old head
                        q.copy_(rolled)
                if j in dec_plan or mirror in pairs:
                    if _enc_has_input(cfg, mirror, phase):
                        h = torch.cat([h, skips[mirror - 1]], dim=-1)

            y = torch.einsum("bc,kco->bo", h, model.proj.w) + model.proj.b
            if cfg.mask_output:
                y = torch.sigmoid(y) * frame[..., :cfg.out_channels]
            return state, y

        return step

    return [build(t) for t in range(cfg.period)]


def stream_infer(model: UNet, x: torch.Tensor,
                 cfg: UNetConfig) -> torch.Tensor:
    """Stream a whole (B, T, in_channels) sequence through the inference
    pattern, one frame per push (the offline == online reference harness).
    """
    from repro_torch.engine.session import unet_stream_session
    session = unet_stream_session(model, cfg, batch=x.shape[0],
                                  dtype=x.dtype, device=x.device)
    return session.run(x)


# ---------------------------------------------------------------------------
# Complexity plan (feeds core.complexity: the paper's tables)
# ---------------------------------------------------------------------------

def layer_plan(cfg: UNetConfig) -> list[cx.LayerCost]:
    enc_io, dec_io = _layer_io(cfg)
    plan = []
    for i, (ci, co) in enumerate(enc_io, start=1):
        plan.append(cx.LayerCost(f"enc{i}", cfg.kernel * ci * co, enc_pos=i))
    for j, (ci, co) in enumerate(dec_io, start=1):
        plan.append(cx.LayerCost(f"dec{j}", cfg.kernel * ci * co, dec_pos=j))
    plan.append(cx.LayerCost("proj", 2 * cfg.in_channels * cfg.out_channels,
                             dec_pos=cfg.n_dec + 1))
    return plan


def complexity_report(cfg: UNetConfig) -> cx.ComplexityReport:
    soi = cfg.soi or SOIConvCfg(pairs=())
    return cx.analyze(layer_plan(cfg), cfg.n_enc, cfg.n_dec, soi, fps=cfg.fps)
