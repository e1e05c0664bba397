"""The diagonal linear recurrence of recurrentgemma's RG-LRU:
``h_t = a_t * h_{t-1} + x_t`` over ``(B, S, D)``.

Kernel: ``csrc/lru_scan.cu`` (CUDA C++, sm_90a), which replaces the TPU
kernel ``repro/kernels/lru_scan.py::lru_scan``.

* Bound on the H100: the bytes — a and x read once, h written once, for 2
  flops per element; ~0.030 ms at the outer serving shape (1, 2040, 4096)
  in float32.
* Design: one thread per (b, d) channel walks S in order with a float32
  carry, on a grid ``(B, ceil(D/64))`` of 64-thread blocks, so loads and
  stores are coalesced across d; the next 16 steps of a and x are loaded
  into registers while the current 16 are computed. The product and the
  sum round separately, as the plain version's do, so in float32 the two
  agree bit for bit.
* Held back by: 64 blocks on 132 SMs at B 1, each thread a serial chain of
  S steps (a chunked two-pass scan over S is later work).

No single PyTorch call computes this recurrence. The plain version is
``ref.lru_scan`` (re-exported here as ``plain``); a CPU tensor takes it, a
CUDA tensor launches the kernel or raises. ``lru_scan.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.lru_scan

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _check_cuda(a, x, h0):
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"a {tuple(a.shape)}, x {tuple(x.shape)}: want two "
                         f"(B, S, D) tensors of one shape")
    b, _, d = a.shape
    if h0 is not None and tuple(h0.shape) != (b, d):
        raise ValueError(f"h0 {tuple(h0.shape)} != {(b, d)}")
    if x.dtype not in _DTYPES or a.dtype != x.dtype:
        raise TypeError(f"lru_scan takes float32 or bfloat16 a and x of one "
                        f"dtype, got {a.dtype}/{x.dtype}")
    for name, t in (("a", a), ("x", x), ("h0", h0)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lru_scan(a, x, h0=None):
    """a, x: (B, S, D); h0: (B, D) or None (zeros). Returns ``(h_all,
    h_last)``: h_all (B, S, D) in x's dtype and its last step (B, D); the
    carry is float32."""
    if x.device.type == "cpu":
        return plain(a, x, h0)
    if x.device.type != "cuda":
        raise ValueError(f"lru_scan: unsupported device {x.device}")
    _check_cuda(a, x, h0)
    b, s, d = x.shape
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    h = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.library().repro_lru_scan(
        a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), b, s, d, _build.DTYPE_CODES[_DTYPES[x.dtype]], stream)
    _build.check(rc, "lru_scan")
    lru_scan.launches += 1
    return h, h[:, -1]


lru_scan.launches = 0
