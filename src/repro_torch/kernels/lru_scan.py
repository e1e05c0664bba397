"""The diagonal linear recurrence of recurrentgemma's RG-LRU:
``h_t = a_t * h_{t-1} + x_t`` over ``(B, S, D)``.

Kernel: ``csrc/lru_scan.cu`` (CUDA C++, sm_90a), which replaces the TPU
kernel ``repro/kernels/lru_scan.py::lru_scan``.

* Bound on the H100: the bytes — a and x read once, h written once, for 2
  flops per element; ~0.030 ms at the outer serving shape (1, 2040, 4096)
  in float32. The chain's arithmetic alone (a product and a sum a step)
  would take ~9 µs at 2040 steps.
* Design: one warp owns a chain of ``CHAIN`` = 32 consecutive channels of
  one batch row and walks S in order with a float32 carry. :func:`lru_plan`
  spreads the chains over every SM (B 1, D 4096: 128 blocks of one
  chain-warp, one an SM; B 4: 128 blocks of four) and feeds each through a
  ring of 3 stages of T steps of a and x in shared memory (32 KB a stage
  at B 1), filled by 16-byte ``cp.async`` copies issued two stages ahead of
  the steps, each lane's addresses a constant apart. The
  product and the sum round separately, as the plain version's do, so in
  float32 the two agree bit for bit and a scan split at any step equals
  the whole scan. D not a multiple of 32, or a misaligned a or x, takes
  the edge path: the same chains on plain loads.
* Held back by: one warp an SM issues every copy, step and store of its
  chain, so bf16 (half the bytes) takes about f32's time; fewer chains
  than SMs (B 1 at D < 4096) leave SMs idle.

The gradient: ``LruScanFn`` (a ``torch.autograd.Function``, used by
:func:`lru_scan` whenever grad is on and an input requires it, on both
devices) saves a, h0 and the scan's h_all, and its backward is
:func:`lru_scan_bwd`, the same recurrence run backwards (``c_t = g_t +
a_{t+1} c_{t+1}``, ``dx = c``, ``da_t = c_t h_{t-1}``, ``dh0 = a_0 c_0``).
No TPU kernel computes it: the reference differentiates the associative
scan ``ref.lru_scan`` with XLA. Kernel: ``repro_lru_scan_bwd`` in
``csrc/lru_scan.cu``, float32 only (what the RG-LRU feeds the scan; other
dtypes raise ``NotImplementedError`` under grad).

* Bound on the H100: the bytes — a, g and h read once, dx and da written
  once (5 x 4 bytes an element) for 3 flops an element: ~84 MB, ~0.025
  ms, at the training shape (8, 128, 4096); ~167 MB, ~0.050 ms, at the
  outer prefill shape (1, 2040, 4096).
* Design: the forward's, walked from the end. One chain-warp a chain of
  32 channels; :func:`lru_plan` with three streams (``streams=3``)
  spreads the chains and sizes a ring of a, g and h shifted by one step
  (row t holds h_{t-1}), filled by 16-byte ``cp.async`` copies two stages
  ahead; the carry c and a_{t+1} stay in registers, dx and da are stored
  in the same pass, coalesced. The product and the sum round separately,
  as in the plain ``ref.lru_scan_bwd``, so the two agree bit for bit. D
  not a multiple of 32 or a misaligned input takes the edge path (plain
  loads, kU steps ahead).

No single PyTorch call computes this recurrence or its gradient. The plain
versions are ``ref.lru_scan`` (re-exported here as ``plain``) and
``ref.lru_scan_bwd``; a CPU tensor takes them, a CUDA tensor launches the
kernel or raises. ``lru_scan.launches`` and ``lru_scan_bwd.launches``
count kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.lru_scan

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

# the H100's streaming multiprocessors
SM_COUNT = 132
# channels a chain-warp: a step's row is 128 bytes in float32, 64 in bf16
CHAIN = 32
MAX_WARPS = 8
# a chain-warp's ring of a and x in shared memory: STAGES stages of at most
# STAGE_BYTES, at most RING_BYTES a block (tools/lru_plan_reading.py: at B
# 1 three stages of 32 KB beat more or shorter ones)
STAGES = 3
STAGE_BYTES = 32 * 1024
RING_BYTES = 192 * 1024


class LruPlan(NamedTuple):
    chains: int       # chain-warps in all: B * ceil(D / CHAIN)
    warps: int        # chain-warps a block
    blocks: int       # the grid
    steps: int        # steps a stage (T); 0 on the edge path
    stages: int       # stages of a chain-warp's ring (STAGES); 0 on the
                      # edge path
    smem: int         # dynamic shared memory a block, bytes
    edge: bool        # plain loads, masked lanes (D % CHAIN, misaligned)


def lru_plan(b: int, s: int, d: int, dtype, aligned: bool = True,
             streams: int = 2) -> LruPlan:
    """The launch of ``lru_scan`` on ``(b, s, d)`` a and x of ``dtype``
    (``streams`` 2; the backward's a, g and h: 3); ``aligned``: every
    stream starts on 16 bytes. Chain ``i`` is channels
    ``[(i % n)·CHAIN, (i % n + 1)·CHAIN)`` of batch row ``i // n``
    (``n = ceil(d / CHAIN)``), block ``j`` holds chains ``[j·warps,
    (j+1)·warps)``. Up to ``SM_COUNT`` chains a block holds one (the
    block scheduler spreads them one an SM); past that, as many as it
    takes to keep to one block an SM (at most ``MAX_WARPS``). Each
    chain-warp's ring is ``STAGES`` stages of ``STAGE_BYTES`` of a and x
    (T 128 steps in float32, 256 in bf16), shorter where a block's rings
    would pass ``RING_BYTES`` (B 4: four warps, T 64 in float32); the
    backward's three streams: T 80 at B 1, 16 at B 8 (eight warps)."""
    if min(b, s, d) < 1:
        raise ValueError(f"lru_plan: b={b}, s={s}, d={d}")
    if dtype not in _DTYPES:
        raise TypeError(f"lru_plan: {dtype} is not float32 or bfloat16")
    esz = torch.finfo(dtype).bits // 8
    chains = b * -(-d // CHAIN)
    warps = min(MAX_WARPS, -(-chains // SM_COUNT))
    blocks = -(-chains // warps)
    if d % CHAIN or not aligned:
        return LruPlan(chains, warps, blocks, 0, 0, 0, True)
    row = streams * CHAIN * esz           # a step of every stream
    stage = min(STAGE_BYTES, RING_BYTES // (STAGES * warps))
    steps = stage // row // 8 * 8
    return LruPlan(chains, warps, blocks, steps, STAGES,
                   warps * STAGES * steps * row, False)


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
    for name, t in (("a", a), ("h0", h0)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    # h0 may be any view (a scan's h_last): the wrapper copies it to
    # contiguous float32
    for name, t in (("a", a), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_plan(a, x) -> LruPlan:
    """:func:`lru_plan` for these CUDA tensors (their alignment included)."""
    b, s, d = x.shape
    return lru_plan(b, s, d, x.dtype,
                    aligned=a.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)


@_build.metered("lru_scan")
def lru_scan(a, x, h0=None):
    """a, x: (B, S, D); h0: (B, D) or None (zeros). Returns ``(h_all,
    h_last)``: h_all (B, S, D) in x's dtype and its last step (B, D); the
    carry is float32. With grad mode on and an input that requires grad
    the scan goes through :class:`LruScanFn` (float32 only), whose
    backward is :func:`lru_scan_bwd`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lru_scan: unsupported device {x.device}")
    if _build.needs_grad(a, x, h0):
        for name, t in (("a", a), ("x", x), ("h0", h0)):
            if t is not None and t.dtype != torch.float32:
                raise NotImplementedError(
                    f"lru_scan backward: float32 only, {name} is {t.dtype}")
        h = LruScanFn.apply(a, x, h0)
        return h, h[:, -1]
    return _forward(a, x, h0)


lru_scan.launches = 0


def _forward(a, x, h0):
    """The plain scan of a CPU tensor, or one launch of the kernel."""
    if x.device.type == "cpu":
        return plain(a, x, h0)
    _check_cuda(a, x, h0)
    h = _launch(a, x, h0, launch_plan(a, x))
    lru_scan.launches += 1
    return h, h[:, -1]


class LruScanFn(torch.autograd.Function):
    """The scan with its gradient: h_all = lru_scan(a, x, h0)[0], the
    backward :func:`lru_scan_bwd` on the saved a, h0 and h_all (h_last,
    a view of h_all, reaches it through h_all's cotangent)."""

    @staticmethod
    def forward(ctx, a, x, h0):
        h, _ = _forward(a, x, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        da, dx, dh0 = lru_scan_bwd(a, g.contiguous(), h, h0)
        return da, dx, dh0


@_build.metered("lru_scan_bwd")
def lru_scan_bwd(a, g, h, h0=None):
    """The gradient of :func:`lru_scan` (see ``ref.lru_scan_bwd``): a, g
    (the cotangent of h_all), h (h_all) (B, S, D) and h0 (B, D) or None,
    all float32. Returns (da, dx, dh0 or None). A CPU tensor takes the
    plain ``ref.lru_scan_bwd``; a CUDA tensor launches the kernel (one
    count in ``lru_scan_bwd.launches``) or raises."""
    for name, t in (("a", a), ("g", g), ("h", h), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise NotImplementedError(
                f"lru_scan_bwd: float32 only, {name} is {t.dtype}")
    if g.device.type == "cpu":
        return ref.lru_scan_bwd(a, g, h, h0)
    if g.device.type != "cuda":
        raise ValueError(f"lru_scan_bwd: unsupported device {g.device}")
    if a.dim() != 3 or a.shape != g.shape or a.shape != h.shape:
        raise ValueError(f"a {tuple(a.shape)}, g {tuple(g.shape)}, h "
                         f"{tuple(h.shape)}: want three (B, S, D) tensors "
                         f"of one shape")
    b, s, d = a.shape
    if h0 is not None and tuple(h0.shape) != (b, d):
        raise ValueError(f"h0 {tuple(h0.shape)} != {(b, d)}")
    for name, t in (("a", a), ("g", g), ("h", h), ("h0", h0)):
        if t is None:
            continue
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    plan = lru_plan(b, s, d, torch.float32, streams=3, aligned=all(
        t.data_ptr() % 16 == 0 for t in (a, g, h)))
    da, dx = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = _build.library().repro_lru_scan_bwd(
        a.data_ptr(), g.data_ptr(), h.data_ptr(),
        None if h0 is None else h0.data_ptr(), dx.data_ptr(), da.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), b, s, d, plan.warps,
        plan.stages, plan.steps, int(plan.edge), stream)
    _build.check(rc, "lru_scan_bwd")
    lru_scan_bwd.launches += 1
    return da, dx, dh0


lru_scan_bwd.launches = 0


def _launch(a, x, h0, plan: LruPlan):
    """The kernel on checked CUDA tensors at ``plan`` (the wrapper's, or
    another for ``tools/lru_plan_reading.py``); returns h_all."""
    b, s, d = x.shape
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    h = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.library().repro_lru_scan(
        a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), b, s, d, plan.warps, plan.stages, plan.steps,
        int(plan.edge), _build.DTYPE_CODES[_DTYPES[x.dtype]], stream)
    _build.check(rc, "lru_scan")
    return h
