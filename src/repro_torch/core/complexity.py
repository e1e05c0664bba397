"""Exact MAC accounting for SOI inference patterns (the port's own copy of
``repro.core.complexity``, which is plain Python but imports the
reference's JAX-importing ``repro.core.soi``).

The paper's headline results are complexity numbers: MACs per second
retained by each SOI placement relative to the STMC baseline. They follow
from the layer plan and the SOI phase schedule alone:

  * ``r_p`` = share of baseline MACs inside pair p's compressed region
    (encoder p..n plus decoder 1..n-p+1);
  * single S-CC at p (PP):            retain = 1 - r_p / 2;
  * nested pairs p1 < p2 (stride 2):  retain = 1 - (r_p1 - r_p2)/2 - 3/4 r_p2;
  * FP/hybrid with the time shift at Y: precomputed fraction = r_Y.

A *layer plan* is a list of ``LayerCost``; ``models.unet.layer_plan``
emits the U-Net's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.soi import SOIConvCfg, region_rates


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """One compute site of the streaming network.

    macs: multiply-accumulates per computed output frame (e.g. K*Cin*Cout).
    enc_pos / dec_pos: 1-indexed position in the mirrored encoder/decoder
      stack (exactly one of them set; an output head uses dec_pos =
      n_dec + 1, i.e. always on).
    """
    name: str
    macs: float
    enc_pos: int | None = None
    dec_pos: int | None = None


@dataclasses.dataclass(frozen=True)
class ComplexityReport:
    macs_per_frame: float          # average over the SOI phase period
    baseline_macs_per_frame: float
    retain: float                  # macs / baseline
    peak_macs_per_frame: float     # worst single inference
    on_arrival_macs_per_frame: float  # FP: what must run after data arrives
    precomputed_fraction: float    # FP: share of baseline MACs done early
    mmacs_per_s: float
    baseline_mmacs_per_s: float
    per_layer: tuple

    def as_row(self) -> dict:
        return {
            "MMAC/s": round(self.mmacs_per_s, 1),
            "retain_%": round(100.0 * self.retain, 1),
            "precomputed_%": round(100.0 * self.precomputed_fraction, 1),
        }


def _rates(plan: Sequence[LayerCost], n_enc: int, n_dec: int,
           cfg: SOIConvCfg) -> list[float]:
    enc_r, dec_r = region_rates(n_enc, n_dec, cfg)
    rates = []
    for lc in plan:
        if lc.enc_pos is not None:
            rates.append(enc_r[lc.enc_pos - 1])
        else:
            rates.append(dec_r[lc.dec_pos - 1] if lc.dec_pos <= n_dec else 1.0)
    return rates


def region_share(plan: Sequence[LayerCost], n_enc: int, n_dec: int,
                 pos: int) -> float:
    """r_pos — share of baseline MACs in the compressed region of a pair at
    ``pos``: encoder pos..n_enc and decoder 1..(n_dec-pos+1)."""
    total = sum(lc.macs for lc in plan)
    region = 0.0
    for lc in plan:
        if lc.enc_pos is not None and lc.enc_pos >= pos:
            region += lc.macs
        elif lc.dec_pos is not None and lc.dec_pos <= n_dec - pos + 1:
            region += lc.macs
    return region / total


def analyze(plan: Sequence[LayerCost], n_enc: int, n_dec: int,
            cfg: SOIConvCfg, *, fps: float = 62.5) -> ComplexityReport:
    """Average / peak / precomputable MACs of a plan under an SOI config."""
    baseline = sum(lc.macs for lc in plan)
    rates = _rates(plan, n_enc, n_dec, cfg)
    avg = sum(lc.macs * r for lc, r in zip(plan, rates))

    # peak = the full-recompute phase (every pair fresh)
    peak = baseline

    # FP: the compressed region downstream of the time shift runs on data
    # already seen, so it can be computed between inferences; the shift
    # sits at shift_pos (SS-CC: fused with the innermost pair)
    shift = cfg.shift_pos
    if cfg.mode == "fp" and shift is None and cfg.pairs:
        shift = cfg.pairs[-1]
    if shift is not None:
        def _in_region(lc):
            return ((lc.enc_pos is not None and lc.enc_pos >= shift)
                    or (lc.dec_pos is not None
                        and lc.dec_pos <= n_dec - shift + 1))
        pre_share = region_share(plan, n_enc, n_dec, shift)
        pre_macs = sum(lc.macs * r for lc, r in zip(plan, rates)
                       if _in_region(lc))
        on_arrival = avg - pre_macs
        peak = baseline - sum(lc.macs for lc in plan if _in_region(lc))
    else:
        pre_share = 0.0
        on_arrival = avg

    per_layer = tuple((lc.name, lc.macs, r) for lc, r in zip(plan, rates))
    return ComplexityReport(
        macs_per_frame=avg,
        baseline_macs_per_frame=baseline,
        retain=avg / baseline,
        peak_macs_per_frame=peak,
        on_arrival_macs_per_frame=on_arrival,
        precomputed_fraction=pre_share,
        mmacs_per_s=avg * fps / 1e6,
        baseline_mmacs_per_s=baseline * fps / 1e6,
        per_layer=per_layer,
    )


def closed_form_retain(shares: Sequence[float], pairs: Sequence[int],
                       stride: int = 2) -> float:
    """Closed-form retain from region shares r_p (``shares[p-1]`` for
    position p): a layer nested inside d pairs runs at rate stride^-d, so
    ``savings = sum_d (r_{p_d} - r_{p_{d+1}}) * (1 - stride^-d)``."""
    sp = sorted(pairs)
    retain = 1.0
    for depth, p in enumerate(sp, start=1):
        r_here = shares[p - 1]
        r_inner = shares[sp[depth] - 1] if depth < len(sp) else 0.0
        retain -= (r_here - r_inner) * (1.0 - stride ** (-depth))
    return retain
