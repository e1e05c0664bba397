"""Short-Term Memory Convolutions (port of ``repro.core.stmc``): the
offline causal conv, and the streaming path that keeps each layer's last
``(K-1)*dilation`` input frames (its *partial state*) and contracts one
tap window per new frame.

Layout conventions, as in the reference:
  activations  x : (B, T, C)
  conv weights w : (K, Cin, Cout)   -- kernel taps oldest..newest
  stream frame   : (B, C)
  conv state     : (B, (K-1)*dilation, Cin)

The per-frame contraction goes through ``kernels.ops.stmc_conv``: the
plain version for a CPU tensor, the hand-written CUDA kernel for a CUDA
tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def conv_init(generator: torch.Generator, kernel: int, cin: int, cout: int,
              *, bias: bool = True, device=None,
              dtype=torch.float32) -> dict:
    """He-uniform init for a causal conv (K, Cin, Cout), zero bias (the
    reference's distribution, not its numbers). ``generator`` must live on
    ``device``."""
    bound = (6.0 / (kernel * cin)) ** 0.5
    w = torch.empty((kernel, cin, cout), dtype=torch.float32, device=device)
    w.uniform_(-bound, bound, generator=generator)
    params = {"w": w.to(dtype)}
    if bias:
        params["b"] = torch.zeros((cout,), dtype=dtype, device=device)
    return params


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


def stmc_init_state(batch: int, kernel: int, cin: int, *, dilation: int = 1,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Zero partial state == the left zero-padding of the offline graph."""
    return torch.zeros((batch, (kernel - 1) * dilation, cin), dtype=dtype,
                       device=device)


def stmc_push(state: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """Update the ring buffer without computing the conv: what a layer
    that SOI skips this frame still does, so its partial state stays
    fresh."""
    if state.shape[1] == 0:
        return state
    return torch.cat([state[:, 1:], frame[:, None, :]], dim=1)


def stmc_window(state: torch.Tensor, frame: torch.Tensor, *,
                dilation: int = 1) -> torch.Tensor:
    """The contiguous (B, K, Cin) tap window ending at the current frame."""
    window = torch.cat([state, frame[:, None, :]], dim=1)
    if dilation > 1:
        window = window[:, ::dilation, :].contiguous()
    return window


def stmc_step(state: torch.Tensor, frame: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor | None = None, *,
              dilation: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming inference of a causal conv: (state, frame) ->
    (state', y), equal to column t of ``causal_conv1d``.

    The contraction has one route, ``ops.stmc_conv``: the reference's
    ``use_kernel=True`` branch, chosen as the port chooses every kernel —
    by the tensor's device. On the CPU that is the plain version, which
    computes the reference's einsum branch (window . w + b); on the card it
    is the CUDA kernel. There is no flag that sends a CUDA tensor to the
    plain version.
    """
    window = stmc_window(state, frame, dilation=dilation)
    y = ops.stmc_conv(window, w, b)
    return stmc_push(state, frame), y


def stream_scan(params: dict, x: torch.Tensor, *,
                dilation: int = 1) -> torch.Tensor:
    """Run a whole (B, T, Cin) sequence through the streaming path, frame
    by frame (the reference's ``lax.scan``, as a Python loop)."""
    k, cin, _ = params["w"].shape
    state = stmc_init_state(x.shape[0], k, cin, dilation=dilation,
                            dtype=x.dtype, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        state, y = stmc_step(state, x[:, t], params["w"], params.get("b"),
                             dilation=dilation)
        ys.append(y)
    return torch.stack(ys, dim=1)
