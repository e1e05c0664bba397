"""Chunked-prefill attention: C queries at absolute positions against
cache-plus-chunk keys at absolute positions.

Kernel: ``csrc/chunk_attention.cu`` (CUDA C++, sm_90a), which replaces the
TPU kernel ``repro/kernels/chunk_attention.py::chunk_attention``.

* Bound on the H100: at the serving shapes (q (1, 256, 16, 128) against
  Sk = 1088 + 256 keys; the middle's (1, 128, 16, 128) against 768 + 128
  frames) the live (query, key) pairs cost 4·H·dh flops each, against a
  few MB of q/k/v/o — a few µs either way on the tensor cores.
* Design: the flash kernel with the position test in place of the index
  causal limit: grid ``(ceil(C/64), B*H)``, 64-row q tiles in shared
  memory, the whole of Sk walked in 64-key tiles (ring rows are not sorted
  by position, so no tile can be skipped by index), a key live iff
  ``0 <= kp <= qp`` (and ``kp > qp - window``), float32 online softmax with
  the finite ``-1e30`` mask and the ``max(l, 1e-30)`` clamp, so query pad
  rows (``qp = -1``) come out finite. Optional logit softcap.
* Held back by: scalar float32 FMAs on the CUDA cores (not
  ``mma.sync``/``wgmma``), and 64 (outer) or 32 (middle) blocks on 132
  SMs at the serving shapes.

The plain version is ``ref.chunk_attention`` (re-exported here as
``plain``); a CPU tensor takes it, a CUDA tensor launches the kernel or
raises. ``chunk_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.chunk_attention

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
HEAD_DIMS = (16, 32, 64, 128)


def _check_cuda(q, k, v, q_positions, k_positions):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B,C,H,dh), (B,Sk,Hkv,dh)")
    b, c, h, dh = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if tuple(q_positions.shape) != (b, c):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != "
                         f"{(b, c)}")
    if tuple(k_positions.shape) != (b, sk):
        raise ValueError(f"k_positions {tuple(k_positions.shape)} != "
                         f"{(b, sk)}")
    if dh not in HEAD_DIMS:
        raise NotImplementedError(f"chunk_attention kernel takes dh in "
                                  f"{HEAD_DIMS}, got {dh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"chunk_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    for name, t in (("q", q), ("k", k), ("v", v),
                    ("q_positions", q_positions),
                    ("k_positions", k_positions)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def chunk_attention(q, k, v, q_positions, k_positions, *, window=None,
                    scale=None, logit_softcap=None):
    """q: (B, C, H, dh); k, v: (B, Sk, Hkv, dh) with H a multiple of Hkv;
    q_positions (B, C) and k_positions (B, Sk) int32 absolute positions,
    ``-1`` = empty. Returns (B, C, H, dh) in q's dtype."""
    if q.device.type == "cpu":
        return plain(q, k, v, q_positions, k_positions, window=window,
                     scale=scale, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_attention: unsupported device {q.device}")
    _check_cuda(q, k, v, q_positions, k_positions)
    b, c, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    scale = dh ** -0.5 if scale is None else float(scale)
    win = 0 if window is None else int(window)
    if window is not None and win <= 0:
        raise ValueError(f"window must be positive, got {window}")
    cap = 0.0 if not logit_softcap else float(logit_softcap)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.library().repro_chunk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        k_positions.data_ptr(), out.data_ptr(), b, c, sk, h, hkv, dh, win,
        scale, cap, _build.DTYPE_CODES[_DTYPES[q.dtype]], stream)
    _build.check(rc, "chunk_attention")
    chunk_attention.launches += 1
    return out


chunk_attention.launches = 0
