"""Closed-form costs of the hand-written kernels, keyed by kernel name
(port of ``repro.kernels.costs``).

The cost meter (``repro_torch.analysis.meter``) prices a torch program by
counting the aten ops it dispatches. A kernel of ``kernels/ops.py`` is one
opaque ctypes launch on the card: no aten op inside it shows its products
to the meter, so an unpriced kernel would silently delete its FLOPs/bytes
from the certification (the off-phase floor of COST001, the paged-bytes
bound of COST002). This registry closes that hole: every kernel registers
the same closed-form cost the reference's HLO parser charges its pure-JAX
reference path, and the meter prices every kernel call through it — on the
CPU too, where the wrapper runs its plain version, whose own ops the meter
then leaves out, so CPU and card count the same. A kernel of
``ops.KERNELS`` whose name is NOT registered here is reported as
``unpriced_kernels`` and fails the cost pass loudly.

Pure Python on purpose (no torch): the formulas are the reference's,
copied so the port imports nothing of ``repro``, and a test holds each one
to ``repro.kernels.costs.price`` on the same shapes.

Conventions:

* a formula receives the call's result :class:`Shape` and the tuple of
  operand :class:`Shape`\\ s, in the REFERENCE kernel's operand order
  (scalar-prefetch operands first, as in the lowered custom-call — the
  page map of a paged read); the meter maps each wrapper's arguments onto
  that order;
* FLOPs follow the reference parser's matmul convention (2 * out_elems *
  contracted), which is also ``torch.utils.flop_counter``'s;
* bytes are true HBM traffic, which for the paged kernels is the GATHERED
  pages only — the pool is never read densely.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Shape:
    """One operand/result: dtype string, dims tuple, total bytes."""
    dtype: str
    dims: tuple
    bytes: int

    @property
    def elems(self) -> int:
        return math.prod(self.dims) if self.dims else 1


def _io_bytes(out: Shape, ops) -> float:
    return float(out.bytes + sum(o.bytes for o in ops))


KERNEL_COSTS: dict = {}


def register(name: str):
    def deco(fn):
        KERNEL_COSTS[name] = fn
        return fn
    return deco


def price(name: str, out: Shape, ops) -> dict | None:
    """``{"flops", "bytes"}`` for a registered kernel name, else None."""
    fn = KERNEL_COSTS.get(name)
    return None if fn is None else fn(out, tuple(ops))


# --- attention family -------------------------------------------------------

@register("flash_attention")
def _flash_attention(out, ops):
    # q (B,Sq,H,dh), k (B,Sk,H,dh), v: QK^T + PV = 4 * q_elems * Sk.
    # Phrased in q.elems so GQA-grouped reshapes of q don't change the price
    sk = ops[1].dims[1]
    return {"flops": 4.0 * ops[0].elems * sk,
            "bytes": _io_bytes(out, ops)}


@register("chunk_attention")
def _chunk_attention(out, ops):
    # q (B,C,[Hkv,g|H],dh), k (B,Sk,Hkv,dh), v, q_positions, k_positions
    sk = ops[1].dims[1]
    return {"flops": 4.0 * ops[0].elems * sk,
            "bytes": _io_bytes(out, ops)}


@register("mla_chunk_attention")
def _mla_chunk_attention(out, ops):
    # q_lat (B,C,H,L), q_rope (B,C,H,R), latent (B,Sk,L), rope (B,Sk,R):
    # scores contract L+R per head, values reuse the latent (L out dims)
    sk = ops[2].dims[1]
    return {"flops": 2.0 * sk * (2 * ops[0].elems + ops[1].elems),
            "bytes": _io_bytes(out, ops)}


@register("decode_attention")
def _decode_attention(out, ops):
    # q (B,[Hkv,g|H],dh), k_cache (B,S,Hkv,dh), v_cache, positions, t
    s = ops[1].dims[1]
    return {"flops": 4.0 * ops[0].elems * s,
            "bytes": _io_bytes(out, ops)}


@register("paged_decode_attention")
def _paged_decode_attention(out, ops):
    # page_map (B,n_pp) [scalar prefetch], q (B,Hkv,g,dh),
    # k_pool (n_pages,p_sz,Hkv,dh), v_pool, pos_pool, t
    b, n_pp = ops[0].dims
    p_sz = ops[2].dims[1]
    row = ops[2].bytes / max(ops[2].dims[0], 1)     # one page of k
    # traffic: q + out + the GATHERED k/v/pos pages, never the whole pool
    gathered = b * n_pp * (2.0 * row
                           + ops[4].bytes / max(ops[4].dims[0], 1))
    return {"flops": 4.0 * ops[1].elems * n_pp * p_sz,
            "bytes": float(ops[0].bytes + ops[1].bytes + out.bytes
                           + gathered)}


@register("paged_mla_decode_attention")
def _paged_mla_decode_attention(out, ops):
    # page_map (B,n_pp) [scalar prefetch], q_lat (B,H,L), q_rope (B,H,R),
    # lat_pool (n_pages,p_sz,L), rope_pool (n_pages,p_sz,R), pos_pool, t
    b, n_pp = ops[0].dims
    p_sz = ops[3].dims[1]
    s = n_pp * p_sz
    gathered = b * n_pp * sum(o.bytes / max(o.dims[0], 1)
                              for o in ops[3:6])
    return {"flops": 2.0 * s * (2 * ops[1].elems + ops[2].elems),
            "bytes": float(ops[0].bytes + ops[1].bytes + ops[2].bytes
                           + out.bytes + gathered)}


@register("flash_attention_bwd")
def _flash_attention_bwd(out, ops):
    # q (B,Sq,H,dqk), k (B,Sk,Hkv,dqk), v (B,Sk,Hkv,dv), o, do
    # (B,Sq,H,dv), lse; out: the (dq, dk, dv) tuple. dV = P^T dO and
    # dP = dO V^T contract or span dv (2 * Sk * do_elems each), dQ = dS K
    # and dK = dS^T Q dqk (2 * Sk * q_elems each), so the price holds at
    # dv != dqk (MLA's 192 / 128). The reference has no backward
    # kernel: it differentiates ref.chunked_flash_attention with XLA, and
    # its parser charges jax.grad of it 6 * Sk * (q_elems + do_elems) —
    # QK^T and PV forward, dV, dP, dQ, dK backward. The forward's two are
    # charged to the flash_attention call the training step launches
    # before this one, so the backward's own price is the other four:
    # together the step is charged what the reference charges jax.grad.
    sk = ops[1].dims[1]
    return {"flops": 4.0 * sk * (ops[0].elems + ops[4].elems),
            "bytes": _io_bytes(out, ops)}


# --- data movement / recurrences -------------------------------------------

@register("copy_pages")
def _copy_pages(out, ops):
    # src_dst table (2,n) [scalar prefetch], pool (n_pages, ...)
    n_copies = ops[0].dims[-1]
    row = ops[1].bytes / max(ops[1].dims[0], 1)
    # each copied page: one read + one write; the aliased pool moves nothing
    return {"flops": 0.0,
            "bytes": float(ops[0].bytes + 2.0 * n_copies * row)}


@register("lru_scan")
def _lru_scan(out, ops):
    # a (B,S,D), x (B,S,D) [, h0 (B,D)]: h = a*h + x per element
    return {"flops": 2.0 * ops[0].elems,
            "bytes": _io_bytes(out, ops)}


@register("lru_scan_bwd")
def _lru_scan_bwd(out, ops):
    # a, g, h (B,S,D) [, h0 (B,D)]; out: the (da, dx[, dh0]) tuple. No
    # reference kernel: the reference differentiates the associative scan
    # with XLA. c = a*c + g and da = c*h_prev: 3 FLOPs an element
    return {"flops": 3.0 * ops[0].elems,
            "bytes": _io_bytes(out, ops)}


@register("stmc_conv")
def _stmc_conv(out, ops):
    # window (B,K), w (K,N) [, w_t, b]: one GEMM against the unrolled taps
    k = ops[1].dims[0]
    return {"flops": 2.0 * out.elems * k,
            "bytes": _io_bytes(out, ops)}
