"""The STMC streaming-conv contraction: one frame's ``(B, K, Cin)`` tap
window against a causal conv's ``(K, Cin, Cout)`` kernel, plus the bias —
the per-frame hot loop of the paper's streaming U-Net.

Kernel: ``csrc/stmc_conv.cu`` (CUDA C++, sm_90a), which replaces the TPU
kernel ``repro/kernels/stmc_conv.py::stmc_conv``.

* Bound on the H100: the bytes. At the U-Net's shapes B <= 32 rows meet up
  to 19.25 MB of float32 weights a layer (decoder 2 of soi-unet-dns: K*Cin
  7248, Cout 664), at most 2*B flops per weight element; least time 5.7 µs
  there at any B <= 32.
* Design: a block owns 32 output columns and up to 8 rows of B, so each
  weight row is read once, as one coalesced line, for all its rows; its 16
  warps split K*Cin with 16 weight loads in flight a thread; the window
  tile is staged in shared memory as float32; float32 accumulators whose
  per-warp partials are added in a fixed order (no atomics: float32
  results repeat bit for bit); bias and cast at the store; the ragged B and
  Cout edges masked (the TPU kernel pads both to 128).
* Held back by: few blocks at B 1 (ceil(Cout/32): 21 at decoder 2, 4 at
  decoder 7, on 132 SMs). Split-K across blocks or TMA is later work.

The plain version is ``ref.stmc_conv`` (re-exported here as ``plain``); a
CPU tensor takes it, a CUDA tensor launches the kernel or raises.
``stmc_conv.launches`` counts kernel launches. ``torch.addmm`` computes the
same function in one call; ``chip_smoke.py`` times it as a yardstick, and
the port never calls it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.stmc_conv

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _check_cuda(window, w, b):
    if window.dim() != 3 or w.dim() != 3:
        raise ValueError(f"window {tuple(window.shape)}, w {tuple(w.shape)}: "
                         f"want (B, K, Cin) and (K, Cin, Cout)")
    bsz, k, cin = window.shape
    if tuple(w.shape[:2]) != (k, cin) or min(bsz, k, cin, w.shape[2]) < 1:
        raise ValueError(f"window {tuple(window.shape)} does not match w "
                         f"{tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[2],):
        raise ValueError(f"b {tuple(b.shape)} != ({w.shape[2]},)")
    if window.dtype not in _DTYPES or w.dtype != window.dtype or (
            b is not None and b.dtype != window.dtype):
        raise TypeError(f"stmc_conv takes float32 or bfloat16 window, w and b "
                        f"of one dtype, got {window.dtype}/{w.dtype}/"
                        f"{None if b is None else b.dtype}")
    for name, t in (("window", window), ("w", w), ("b", b)):
        if t is None:
            continue
        if t.device != window.device:
            raise ValueError(f"{name} is on {t.device}, window on "
                             f"{window.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def stmc_conv(window, w, b=None):
    """window: (B, K, Cin); w: (K, Cin, Cout); b: (Cout,) or None. Returns
    ``window . w + b`` as (B, Cout) in the window's dtype, accumulated in
    float32."""
    if window.device.type == "cpu":
        return plain(window, w, b)
    if window.device.type != "cuda":
        raise ValueError(f"stmc_conv: unsupported device {window.device}")
    _check_cuda(window, w, b)
    bsz, k, cin = window.shape
    cout = w.shape[2]
    y = torch.empty((bsz, cout), dtype=window.dtype, device=window.device)
    stream = torch.cuda.current_stream(window.device).cuda_stream
    rc = _build.library().repro_stmc_conv(
        window.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), bsz, k * cin, cout,
        _build.DTYPE_CODES[_DTYPES[window.dtype]], stream)
    _build.check(rc, "stmc_conv")
    stmc_conv.launches += 1
    return y


stmc_conv.launches = 0
