"""Scattered Online Inference for conv encoder/decoder networks (port of
``repro.core.soi``).

  * **S-CC pair** (Strided-Cloned Convolution): a stride-``s`` causal conv
    compresses time (``scc_compress``); the mirrored point of the network
    restores full rate by duplicating the last computed frame
    (``scc_extrapolate``) or by a transposed conv.
  * **SC layer** (Shifted Convolution): a one-step time shift
    (``sc_shift``) that turns reconstructed frames into predictions (Fully
    Predictive mode); **SS-CC** fuses the two (``ss_cc_extrapolate``).

``region_rates`` and ``phase_schedule`` are the rate/phase bookkeeping
that the complexity accounting and the online steppers share.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.stmc import causal_conv1d


@dataclasses.dataclass(frozen=True)
class SOIConvCfg:
    """SOI configuration for a conv encoder/decoder network (e.g. U-Net).

    Attributes:
      pairs: encoder positions (1-indexed) that become S-CC compress points;
        the extrapolation happens at the mirrored decoder position. Sorted
        ascending.
      mode: "pp" or "fp".
      stride: temporal stride of each S-CC pair (the paper uses 2).
      extrapolation: "dup" (frame duplication, the paper's default) or
        "tconv" (transposed convolution, the paper's appendix E).
      shift_pos: FP hybrid only — encoder position of the SC time shift.
        ``None`` in FP mode fuses the shift with the outermost pair (SS-CC).
    """
    pairs: tuple[int, ...] = ()
    mode: str = "pp"
    stride: int = 2
    extrapolation: str = "dup"
    shift_pos: int | None = None

    def __post_init__(self):
        if self.mode not in ("pp", "fp"):
            raise ValueError(f"mode {self.mode!r}: want 'pp' or 'fp'")
        if self.extrapolation not in ("dup", "tconv"):
            raise ValueError(f"extrapolation {self.extrapolation!r}: want "
                             f"'dup' or 'tconv'")
        if tuple(sorted(self.pairs)) != tuple(self.pairs):
            raise ValueError(f"pairs {self.pairs} must be sorted")


# ---------------------------------------------------------------------------
# Offline (training) graph ops: the semantics the online stepper matches.
# ---------------------------------------------------------------------------

def scc_compress(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None = None, *,
                 stride: int = 2) -> torch.Tensor:
    """S-CC phase 1: strided causal conv. Output frame s sees inputs
    <= s*stride."""
    return causal_conv1d(x, w, b, stride=stride)


def scc_extrapolate(y: torch.Tensor, *, stride: int = 2,
                    out_len: int | None = None, w: torch.Tensor | None = None,
                    b: torch.Tensor | None = None) -> torch.Tensor:
    """S-CC phase 2: restore full rate by duplication (``w`` None) or by a
    transposed conv with kernel (stride, Cin, Cout), where output frame
    ``s*stride + k`` is ``y_s . w[k] + b``. Compressed frame s covers
    output times ``s*stride .. s*stride + stride-1``."""
    if w is None:
        up = torch.repeat_interleave(y, stride, dim=1)
    else:
        up = torch.einsum("btc,kco->btko", y, w)
        if b is not None:
            up = up + b
        up = up.reshape(y.shape[0], y.shape[1] * stride, -1)
    if out_len is not None:
        up = up[:, :out_len]
    return up


def sc_shift(x: torch.Tensor, *, shift: int = 1) -> torch.Tensor:
    """SC layer: shift activations ``shift`` steps into the future
    (prepend zeros, drop the last frames)."""
    if shift == 0:
        return x
    pad = torch.zeros_like(x[:, :shift])
    return torch.cat([pad, x[:, :-shift]], dim=1)


def ss_cc_extrapolate(y: torch.Tensor, *, stride: int = 2, shift: int = 1,
                      out_len: int | None = None,
                      w: torch.Tensor | None = None,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """SS-CC: extrapolate first, then shift (the paper's §2.1 order)."""
    up = scc_extrapolate(y, stride=stride, out_len=out_len, w=w, b=b)
    return sc_shift(up, shift=shift)


# ---------------------------------------------------------------------------
# Rate/phase bookkeeping
# ---------------------------------------------------------------------------

def region_rates(n_enc: int, n_dec: int,
                 cfg: SOIConvCfg) -> tuple[list, list]:
    """Per-layer average recomputation rate (the share of inferences in
    which the layer's conv runs) of a mirrored encoder/decoder network:
    decoder layer j mirrors encoder layer ``n_enc - j + 1``, and pair p's
    compressed region is encoder p..n_enc plus decoder 1..(n_dec - p + 1).
    """
    enc = []
    rate = 1.0
    for i in range(1, n_enc + 1):
        if i in cfg.pairs:
            rate /= cfg.stride
        enc.append(rate)
    dec = []
    for j in range(1, n_dec + 1):
        mirror = n_enc - j + 1
        rate = 1.0
        for p in cfg.pairs:
            if p <= mirror:
                rate /= cfg.stride
        dec.append(rate)
    return enc, dec


def phase_schedule(cfg: SOIConvCfg, n_enc: int) -> list[dict]:
    """For each phase t = 0..period-1 (period = stride ** len(pairs)), how
    deep the network recomputes: ``enc_depth`` (encoder layers
    1..enc_depth run their convs) and ``stale_pair`` (position of the
    outermost stale pair, None on a full pass). Pair k produces a fresh
    compressed frame exactly when ``t % stride**k == 0``."""
    period = cfg.stride ** len(cfg.pairs)
    sched = []
    for t in range(period):
        depth, stale = n_enc, None
        divisor = 1
        for p in cfg.pairs:
            divisor *= cfg.stride
            if t % divisor != 0:
                depth, stale = p - 1, p
                break
        sched.append({"enc_depth": depth, "stale_pair": stale})
    return sched
