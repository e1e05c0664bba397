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

No single PyTorch call computes this recurrence. The plain version is
``ref.lru_scan`` (re-exported here as ``plain``); a CPU tensor takes it, a
CUDA tensor launches the kernel or raises. ``lru_scan.launches`` counts
kernel launches.
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


def lru_plan(b: int, s: int, d: int, dtype, aligned: bool = True) -> LruPlan:
    """The launch of ``lru_scan`` on ``(b, s, d)`` a and x of ``dtype``;
    ``aligned``: both start on 16 bytes. Chain ``i`` is channels
    ``[(i % n)·CHAIN, (i % n + 1)·CHAIN)`` of batch row ``i // n``
    (``n = ceil(d / CHAIN)``), block ``j`` holds chains ``[j·warps,
    (j+1)·warps)``. Up to ``SM_COUNT`` chains a block holds one (the
    block scheduler spreads them one an SM); past that, as many as it
    takes to keep to one block an SM (at most ``MAX_WARPS``). Each
    chain-warp's ring is ``STAGES`` stages of ``STAGE_BYTES`` of a and x
    (T 128 steps in float32, 256 in bf16), shorter where a block's rings
    would pass ``RING_BYTES`` (B 4: four warps, T 64 in float32)."""
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
    row = 2 * CHAIN * esz                 # a step of a and x, one warp
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
    carry is float32."""
    if x.device.type == "cpu":
        return plain(a, x, h0)
    if x.device.type != "cuda":
        raise ValueError(f"lru_scan: unsupported device {x.device}")
    _build.refuse_grad("lru_scan", a, x, h0)
    _check_cuda(a, x, h0)
    h = _launch(a, x, h0, launch_plan(a, x))
    lru_scan.launches += 1
    return h, h[:, -1]


lru_scan.launches = 0


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
