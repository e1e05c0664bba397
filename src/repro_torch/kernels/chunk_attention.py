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

``mla_chunk_attention`` is the absorbed-MLA chunk of deepseek-v2-style
stacks.

Kernel: ``csrc/mla_chunk_attention.cu`` (CUDA C++, sm_90a), which replaces
the TPU kernel ``repro/kernels/chunk_attention.py::mla_chunk_attention``.

* Bound on the H100: operations. At the serving chunk (C 256 against Sk
  1344, H 128, L 512, R 64) the (query, key) pairs cost ``2·(L+R+L)``
  flops per head, ~96 GFLOP (~97 µs on the tensor cores), against ~40 MB
  of q/out and ~1.5 MB of latent rows.
* Design: the chunk kernel with two score terms and the latent as the
  value: grid ``(ceil(C/32), B*H)``, the q_lat|q_rope rows of 32 queries
  in one shared tile of ``L+R`` columns and the latent|rope rows of 32
  keys in another, so one pass gives both score terms and the key tile's
  first ``L`` columns are the value; the in-kernel position test, float32
  online softmax with the finite ``-1e30`` mask and the ``max(l, 1e-30)``
  clamp, so pad query rows (``qp = -1``) come out finite.
* Held back by: scalar float32 FMAs (not ``mma.sync``/``wgmma``), and every
  block reading all Sk latent rows for one head.

The plain versions are ``ref.chunk_attention`` (re-exported here as
``plain``) and ``ref.mla_chunk_attention`` (``mla_plain``); a CPU tensor
takes them, a CUDA tensor launches the kernel or raises.
``chunk_attention.launches`` and ``mla_chunk_attention.launches`` count
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.chunk_attention
mla_plain = ref.mla_chunk_attention

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


# (L, R) latent and rope widths the MLA kernels are instantiated for:
# deepseek-v2's, and the small test stacks'
MLA_DIMS = ((512, 64), (16, 8))


def _check_mla_cuda(q_lat, q_rope, latent, rope, q_positions, k_positions,
                    out_dtype):
    if q_lat.dim() != 4 or q_rope.dim() != 4 or latent.dim() != 3 \
            or rope.dim() != 3:
        raise ValueError(f"q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, latent "
                         f"{tuple(latent.shape)}, rope {tuple(rope.shape)}: "
                         f"want (B,C,H,L), (B,C,H,R), (B,Sk,L), (B,Sk,R)")
    b, c, h, lat_d = q_lat.shape
    r = q_rope.shape[-1]
    sk = latent.shape[1]
    if tuple(q_rope.shape[:3]) != (b, c, h) \
            or tuple(latent.shape) != (b, sk, lat_d) \
            or tuple(rope.shape) != (b, sk, r):
        raise ValueError(f"q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, latent "
                         f"{tuple(latent.shape)}, rope {tuple(rope.shape)} "
                         f"do not match")
    if tuple(q_positions.shape) != (b, c):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != "
                         f"{(b, c)}")
    if tuple(k_positions.shape) != (b, sk):
        raise ValueError(f"k_positions {tuple(k_positions.shape)} != "
                         f"{(b, sk)}")
    if (lat_d, r) not in MLA_DIMS:
        raise NotImplementedError(f"mla_chunk_attention kernel takes (L, R) "
                                  f"in {MLA_DIMS}, got {(lat_d, r)}")
    dts = {q_lat.dtype, q_rope.dtype, latent.dtype, rope.dtype}
    if q_lat.dtype not in _DTYPES or len(dts) != 1:
        raise TypeError(f"mla_chunk_attention takes float32 or bfloat16 "
                        f"inputs of one dtype, got {sorted(map(str, dts))}")
    if out_dtype is not None and out_dtype != q_lat.dtype:
        raise TypeError(f"mla_chunk_attention kernel writes q_lat's dtype "
                        f"{q_lat.dtype}, asked for {out_dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope),
                    ("latent", latent), ("rope", rope),
                    ("q_positions", q_positions),
                    ("k_positions", k_positions)):
        if t.device != q_lat.device:
            raise ValueError(f"{name} is on {t.device}, q_lat on "
                             f"{q_lat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mla_chunk_attention(q_lat, q_rope, latent, rope, q_positions,
                        k_positions, *, scale, out_dtype=None):
    """q_lat: (B, C, H, L) (W_UK absorbed); q_rope: (B, C, H, R); latent:
    (B, Sk, L); rope: (B, Sk, R); q_positions (B, C) and k_positions
    (B, Sk) int32 absolute positions, ``-1`` = empty. Returns o_lat
    (B, C, H, L) in ``out_dtype`` (default q_lat's)."""
    if q_lat.device.type == "cpu":
        return mla_plain(q_lat, q_rope, latent, rope, q_positions,
                         k_positions, scale=scale, out_dtype=out_dtype)
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_chunk_attention: unsupported device "
                         f"{q_lat.device}")
    _check_mla_cuda(q_lat, q_rope, latent, rope, q_positions, k_positions,
                    out_dtype)
    b, c, h, lat_d = q_lat.shape
    r = q_rope.shape[-1]
    sk = latent.shape[1]
    out = torch.empty_like(q_lat)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    rc = _build.library().repro_mla_chunk_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), latent.data_ptr(),
        rope.data_ptr(), q_positions.data_ptr(), k_positions.data_ptr(),
        out.data_ptr(), b, c, sk, h, lat_d, r, float(scale),
        _build.DTYPE_CODES[_DTYPES[q_lat.dtype]], stream)
    _build.check(rc, "mla_chunk_attention")
    mla_chunk_attention.launches += 1
    return out


mla_chunk_attention.launches = 0
