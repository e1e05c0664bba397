"""Short-Term Memory Convolutions (port of the part of ``repro.core.stmc``
that SOI-LM serving needs: the offline causal conv behind the S-CC
compress).

Layout conventions, as in the reference:
  activations  x : (B, T, C)
  conv weights w : (K, Cin, Cout)   -- kernel taps oldest..newest
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *, stride: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """Offline causal 1D convolution.

    Left-pads with ``(K-1)*dilation`` zeros so output frame t only sees
    inputs ``<= t``. With ``stride=s`` output frame j corresponds to input
    time ``j*s``. Any length T yields ``ceil(T/stride)`` frames.

    Written as an unfold of the padded input plus one matrix product, so
    it never reaches cuDNN (whose float32 convolutions default to TF32 on
    the card): the products are plain ``torch.matmul`` in the input dtype.
    """
    k = w.shape[0]
    pad = (k - 1) * dilation
    xp = F.pad(x, (0, 0, pad, 0))                       # (B, pad+T, Cin)
    n_out = (x.shape[1] - 1) // stride + 1
    span = (n_out - 1) * stride + 1
    # taps[:, j, i] = xp[:, j*stride + i*dilation]
    taps = torch.stack(
        [xp[:, i * dilation: i * dilation + span: stride] for i in range(k)],
        dim=2)                                          # (B, n_out, K, Cin)
    y = torch.matmul(taps.flatten(2), w.reshape(-1, w.shape[-1]))
    if b is not None:
        y = y + b
    return y
