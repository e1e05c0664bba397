"""GhostNet-1D for acoustic scene classification — the paper's second
testbed (Table 4: 7 model sizes x {Baseline, STMC, SOI}); port of
``repro.models.ghostnet``.

Ghost module (Han et al. 2020): a primary conv producing cout/2 features
plus a "cheap" conv generating the other half ("ghost" features). Every
conv is causal over time (``core.stmc.causal_conv1d``); SOI makes the
block at each pair position strided (stride-2 temporal compression) and,
after the last block, restores full rate by duplication
(``core.soi.scc_extrapolate``) with a 1x1 skip projection from the
compress point — the U-Net mechanism without the mirrored decoder.

The model runs offline (``apply_offline``: a whole clip to class logits),
as the reference's does; it has no TPU kernel in the reference, and every
product is plain PyTorch on every device. ``layer_plan``,
``complexity_report`` and ``n_params`` are the Table 4 accounting.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import complexity as cx
from repro_torch.core.soi import SOIConvCfg, scc_extrapolate
from repro_torch.core.stmc import causal_conv1d, conv_init


@dataclasses.dataclass(frozen=True)
class GhostNetConfig:
    in_channels: int = 40            # mel bands
    n_classes: int = 10
    widths: tuple = (16, 24, 40, 56, 80)
    kernel: int = 3
    soi: SOIConvCfg | None = None    # pairs index blocks (1-based)
    fps: float = 62.5

    @property
    def n_blocks(self) -> int:
        return len(self.widths)


class Conv(nn.Module):
    """A causal conv's weight ``w`` (K, Cin, Cout) and bias ``b``."""

    def __init__(self, kernel: int, cin: int, cout: int, *, generator,
                 device, dtype):
        super().__init__()
        p = conv_init(generator, kernel, cin, cout, device=device,
                      dtype=dtype)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"])


class Ghost(nn.Module):
    """One ghost block: ``primary`` (K, Cin, cout/2) and ``cheap`` (K,
    cout/2, cout - cout/2)."""

    def __init__(self, k: int, cin: int, cout: int, **kw):
        super().__init__()
        half = cout // 2
        self.primary = Conv(k, cin, half, **kw)
        self.cheap = Conv(k, half, cout - half, **kw)


class GhostNet(nn.Module):
    """``blocks`` (one ``Ghost`` a width), the 1x1 ``head`` and, for SOI
    configs, one 1x1 skip projection a pair (``skip_proj``, keyed by the
    pair position as a string)."""

    def __init__(self, cfg: GhostNetConfig, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        cin = cfg.in_channels
        blocks = []
        for w in cfg.widths:
            blocks.append(Ghost(cfg.kernel, cin, w, **kw))
            cin = w
        self.blocks = nn.ModuleList(blocks)
        self.head = Conv(1, cin, cfg.n_classes, **kw)
        self.skip_proj = nn.ModuleDict()
        if cfg.soi is not None:
            for p in cfg.soi.pairs:
                self.skip_proj[str(p)] = Conv(1, _skip_in(cfg, p),
                                              cfg.widths[-1], **kw)


def _skip_in(cfg: GhostNetConfig, p: int) -> int:
    """Channels of the input of block ``p`` (1-based)."""
    return ([cfg.in_channels] + list(cfg.widths))[p - 1]


def init(cfg: GhostNetConfig, *, generator: torch.Generator, device=None,
         dtype=torch.float32) -> GhostNet:
    """Random weights from ``generator`` (on ``device``) with the
    reference's distributions, on ``device`` — the card unless the caller
    asks for the CPU."""
    return GhostNet(cfg, generator=generator, device=resolve_device(device),
                    dtype=dtype)


def _ghost_apply(g: Ghost, x, *, stride=1):
    h1 = F.relu(causal_conv1d(x, g.primary.w, g.primary.b, stride=stride))
    h2 = F.relu(causal_conv1d(h1, g.cheap.w, g.cheap.b))
    return torch.cat([h1, h2], dim=-1)


@torch.no_grad()
def apply_offline(model: GhostNet, x, cfg: GhostNetConfig):
    """x: (B, T, in_channels) -> logits (B, n_classes) (mean-pooled)."""
    soi = cfg.soi
    pairs = set(soi.pairs) if soi else set()
    h = x
    skips = {}
    for i in range(1, cfg.n_blocks + 1):
        if i in pairs:
            skips[i] = h                       # input of the strided block
        stride = soi.stride if (soi and i in pairs) else 1
        h = _ghost_apply(model.blocks[i - 1], h, stride=stride)
    if soi and pairs:
        # upsample back to full rate after the last block + skip injection
        for p in sorted(pairs, reverse=True):
            h = scc_extrapolate(h, stride=soi.stride,
                                out_len=skips[p].shape[1])
            sp = model.skip_proj[str(p)]
            h = h + causal_conv1d(skips[p], sp.w, sp.b)
    pooled = torch.mean(h, dim=1)
    return torch.matmul(pooled, model.head.w[0]) + model.head.b


# ---------------------------------------------------------------------------
# Complexity (Table 4)
# ---------------------------------------------------------------------------

def layer_plan(cfg: GhostNetConfig) -> list[cx.LayerCost]:
    """Ghost blocks as encoder positions; the pooled head is always-on."""
    plan = []
    cin = cfg.in_channels
    for i, w in enumerate(cfg.widths, start=1):
        half = w // 2
        macs = cfg.kernel * cin * half + cfg.kernel * half * (w - half)
        plan.append(cx.LayerCost(f"ghost{i}", macs, enc_pos=i))
        cin = w
    plan.append(cx.LayerCost("head", cin * cfg.n_classes,
                             dec_pos=cfg.n_blocks + 1))
    if cfg.soi is not None:
        for p in cfg.soi.pairs:
            plan.append(cx.LayerCost(f"skip{p}",
                                     _skip_in(cfg, p) * cfg.widths[-1],
                                     dec_pos=cfg.n_blocks + 1))
    return plan


def complexity_report(cfg: GhostNetConfig) -> cx.ComplexityReport:
    soi = cfg.soi or SOIConvCfg(pairs=())
    # n_dec=0: pure encoder topology — every pair's region runs to the end.
    return cx.analyze(layer_plan(cfg), cfg.n_blocks, 0, soi, fps=cfg.fps)


def n_params(cfg: GhostNetConfig) -> int:
    cin = cfg.in_channels
    total = 0
    for w in cfg.widths:
        half = w // 2
        total += cfg.kernel * cin * half + half          # primary
        total += cfg.kernel * half * (w - half) + (w - half)
        cin = w
    total += cin * cfg.n_classes + cfg.n_classes
    if cfg.soi is not None:
        for p in cfg.soi.pairs:
            total += _skip_in(cfg, p) * cfg.widths[-1] + cfg.widths[-1]
    return total
