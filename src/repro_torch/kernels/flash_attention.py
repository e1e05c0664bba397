"""Causal flash attention for whole-prompt prefill (bucketed, or at the
exact length for configs that cannot mask pad).

Kernel: ``csrc/flash_attention.cu`` (CUDA C++, sm_90a), which replaces the
TPU kernel ``repro/kernels/flash_attention.py::flash_attention``. The value
head dim may differ from the query/key one, as in the TPU kernel: the
kernel takes (d_qk, d_v) in ``HEAD_DIMS`` — the GQA dims and deepseek-v2's
MLA prefill (q/k 192 = qk_nope 128 + qk_rope 64, v 128).

* Bound on the H100: near balanced at the GQA serving shape (S=1024, H=16,
  Hkv=8, dh=128, bf16): ~4.3 GFLOP of causal work (~4.3 µs on the tensor
  cores) against ~12.6 MB of q/k/v/o (~3.8 µs at 3.35 TB/s); at the MLA
  shape (S=1024, H=128, 192/128) ~43 GFLOP against ~168 MB, again near
  balanced (~43 µs against ~50 µs).
* bfloat16 (every serving path): FlashAttention-2 on the tensor cores.
  Both products run as ``mma.sync`` m16n8k16 (bf16 in, f32 accumulate):
  Q·Kᵀ with K fragments by ``ldmatrix``, then P·V with P rounded to bf16
  in registers as the A operand and V by ``ldmatrix.trans``. K/V tiles stay
  bf16 in a 2-stage ``cp.async`` ring (tile j+1 loads while tile j is
  multiplied); the online softmax, ``q_offset``, the causal and ``Sk``
  masks and the optional logit softcap work on the f32 accumulators. A warp
  owns 16 query rows up to d_qk 128 and 32 at the MLA's 192 (where that
  halves the K/V reads a row costs); q tiles are scheduled heaviest first;
  tiles wholly past the diagonal are never loaded, as the TPU kernel's
  ``pl.when(live)`` skips them. No atomics: results repeat bit for bit.
* float32, the dtype of the card-against-CPU parity checks (logits within
  1e-3): the scalar float32 body, kept on the CUDA cores — on the tensor
  cores float32 would become TF32 and lose that parity.
* K/V are read at Hkv heads (q head ``h`` reads KV head ``h // G``), so the
  caller's GQA repeat is not needed.
* Held back by: ``mma.sync`` from each warp on its own, the softmax between
  the products overlapping nothing, ~255 registers a thread (8 warps an
  SM): ~130 TFLOP/s at qwen3's shape and ~210 at the MLA's on an H100
  SXM at 700 W, 1.8× SDPA at both (``PERF.md``). ``wgmma`` with TMA and
  warp specialisation is the next step.

The gradient: ``FlashAttentionFn`` (a ``torch.autograd.Function``) runs
the forward kernel with a float32 ``lse`` (B, H, Sq) output — the rows'
log-sum-exp, null and unwritten when serving — and
``csrc/flash_attention_bwd.cu`` backward (``flash_attention_bwd``, the
FlashAttention-2 recompute: delta = rowsum(dO·O), a dK/dV kernel a key
tile and a dQ kernel a query tile; its plain version is
``ref.flash_attention_bwd``). No TPU kernel computes it: the reference
differentiates ``ref.chunked_flash_attention`` with XLA.

* bfloat16 (training): all five products on the tensor cores
  (``mma.sync``), Q/dO tiles (dK/dV) and K/V tiles (dQ) through 2-stage
  ``cp.async`` rings, P and dS rounded to bf16 in registers as the second
  products' A operands; dK/dV blocks of 32 keys split their walk between
  two warp groups; dQ runs first and computes delta from its own tiles (two
  launches). Bound at the training shape (8, 128, 16/8, 128) by its
  ~25 MB of bytes (7.5 µs), at S 1024 and 4096 by its products (11 and
  174 µs). Held back by shared-memory reads (``mma.sync`` takes every B
  fragment from shared memory for one warp's 16 rows) and registers (at
  dh 128 dK/dV takes 254 of a thread's 255, dQ 248). On an
  H100 SXM at 700 W: 0.028 ms at the training shape (SDPA's
  backward 0.029), 0.11 ms at (1, 1024) and 0.95 at (1, 4096), ~2× SDPA's
  backward there (``PERF.md``, row 2b).
* MLA training (d_qk 192, d_v 128: deepseek-v2's prefill): the same two
  kernels with each product over its own width (S, dQ and dK over d_qk;
  dP, dV and delta over d_v), o and dO at d_v. dK and dV of a warp's 16
  keys would need 160 accumulators a thread there, past the 254 registers
  d 128 holds, so the dK/dV block's two warp groups split the columns
  instead of the walk (each walks every query tile, keeping half of dK's
  and dV's columns), and dQ takes key tiles of 32 (``PERF.md``, row 2b).
* float32: the first design, float32 FMAs on the CUDA cores after a delta
  pre-pass (on the tensor cores it would become TF32 and lose the 2e-5
  parity): three launches.

Both use no atomics, so a result repeats bit for bit.

The plain version is ``ref.flash_attention`` (re-exported here as
``plain``); a CPU tensor takes it, a CUDA tensor launches the kernel or
raises. ``flash_attention.launches`` and ``flash_attention_bwd.launches``
count kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.flash_attention

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# (d_qk, d_v) pairs the forward and backward kernels are instantiated for
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))


def _check_cuda(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B,Sq,H,dqk), "
                         f"(B,Sk,Hkv,dqk), (B,Sk,Hkv,dv)")
    b, sq, h, dh = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if (dh, v.shape[-1]) not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention kernel takes (dqk, dv) "
                                  f"in {HEAD_DIMS}, got {(dh, v.shape[-1])}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def forward_launch(q, k, v, *, causal, q_offset, scale, cap, with_lse):
    """One launch of the forward kernel on checked CUDA tensors (``cap``
    0: no softcap); returns (out, lse float32 (B, H, Sq) or None)."""
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    out = q.new_empty((b, sq, h, dv))
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, sq, sk, h, hkv, dh, dv, int(q_offset), int(bool(causal)), scale,
        cap, _build.DTYPE_CODES[_DTYPES[q.dtype]], stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out, lse


@_build.metered("flash_attention")
def flash_attention(q, k, v, *, causal=True, window=None, prefix_len=0,
                    q_offset=0, scale=None, logit_softcap=None):
    """q: (B, Sq, H, dqk); k: (B, Sk, Hkv, dqk); v: (B, Sk, Hkv, dv) with H
    a multiple of Hkv. ``q_offset`` is the absolute position of ``q[:, 0]``;
    ``scale`` defaults to ``dqk ** -0.5``. Returns (B, Sq, H, dv) in q's
    dtype.

    On the card, with grad mode on and an input that requires grad, the
    launch goes through :class:`FlashAttentionFn`: the forward also writes
    the rows' log-sum-exp and the backward is :func:`flash_attention_bwd`.
    Otherwise it is the serving launch, with no ``lse``. On the CPU the
    plain version is differentiated by autograd."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window,
                     prefix_len=prefix_len, q_offset=q_offset, scale=scale,
                     logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if window is not None or prefix_len:
        raise NotImplementedError("flash_attention kernel: window and "
                                  "prefix_len are not ported yet; see "
                                  "ROADMAP.md")
    _check_cuda(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if _build.needs_grad(q, k, v):
        if logit_softcap:
            raise NotImplementedError("flash_attention backward: "
                                      "logit_softcap is not ported yet; see "
                                      "ROADMAP.md")
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(q_offset),
                                      scale)
    cap = 0.0 if not logit_softcap else float(logit_softcap)
    return forward_launch(q, k, v, causal=causal, q_offset=q_offset,
                          scale=scale, cap=cap, with_lse=False)[0]


flash_attention.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA flash attention with its CUDA gradient: the forward kernel
    (writing ``lse``) and :func:`flash_attention_bwd`. Causal or not,
    ``q_offset``, ``scale``, GQA and every (d_qk, d_v) of ``HEAD_DIMS``
    (MLA's included); no window, prefix or softcap."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, scale):
        out, lse = forward_launch(q, k, v, causal=causal, q_offset=q_offset,
                                  scale=scale, cap=0.0, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, causal=causal,
                                         q_offset=q_offset, scale=scale)
        return dq, dk, dv, None, None, None


@_build.metered("flash_attention_bwd")
def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, q_offset=0,
                        scale=None):
    """The gradient (dq, dk, dv) of :func:`flash_attention`, each in its
    input's dtype: q (B, Sq, H, d_qk), k (B, Sk, Hkv, d_qk), v (B, Sk, Hkv,
    d_v), o and do (B, Sq, H, d_v), lse float32 (B, H, Sq) from the
    forward; (d_qk, d_v) in ``HEAD_DIMS``. A CPU tensor takes the plain
    ``ref.flash_attention_bwd``; a CUDA tensor launches
    ``csrc/flash_attention_bwd.cu`` (delta, dK/dV, dQ: three kernels in
    float32, two in bfloat16; one count in ``flash_attention_bwd.launches``)
    or raises."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                       q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    _check_cuda(q, k, v)
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    dv_ = v.shape[-1]
    for name, t in (("o", o), ("do", do)):
        if t.shape != (b, sq, h, dv_) or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"contiguous {(b, sq, h, dv_)} {q.dtype}")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want "
                         f"contiguous float32 {(b, h, sq)}")
    scale = dh ** -0.5 if scale is None else float(scale)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, hkv, dh, dv_,
        int(q_offset),
        int(bool(causal)), scale, _build.DTYPE_CODES[_DTYPES[q.dtype]],
        stream)
    _build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
