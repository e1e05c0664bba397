"""The STMC streaming-conv contraction: one frame's ``(B, K, Cin)`` tap
window against a causal conv's ``(K, Cin, Cout)`` kernel, plus the bias —
the per-frame hot loop of the paper's streaming U-Net.

Kernel: ``csrc/stmc_conv.cu`` (CUDA C++, sm_90a), which replaces the TPU
kernel ``repro/kernels/stmc_conv.py::stmc_conv``.

* Bound on the H100: the weight bytes. At the U-Net's shapes B <= 32 rows
  meet up to 19.25 MB of float32 weights a layer (decoder 2 of
  soi-unet-dns: K*Cin 7248, Cout 664), at most 2*B flops per weight
  element; least time 5.7 µs there at any B <= 32, and 34.6 µs for the
  ~116 MB of a B 1 frame's 14 convs, which stream from HBM every frame.
* Design: split-K in a thread block cluster, one launch a conv.
  :func:`stmc_plan` gives each cluster of ``splits`` (≤ 8) blocks one tile
  of ``cols`` output columns and each block one range of
  ``keys_per_split`` rows of K*Cin, so a B 1 conv runs on ≥ 132 blocks
  where the shape allows (decoder 2: 21 × 8 = 168) and on no more than the
  SMs hold at once; the ranks' partials meet in distributed shared memory
  and are added in rank order (no atomics: results repeat bit for bit in
  both dtypes). A thread loads 16 bytes of a weight row (4 float32 or 8
  bf16 columns; at least a 32-byte sector a row across a block's threads)
  with two chunks of rows in flight; where Cout × element size is no
  multiple of 16 (or the weights are not 16-byte aligned) the same kernel
  loads the group element by element, masked at Cout. A block holds all
  ``rows`` (≤ 32) rows of B, so each weight byte is read once at B ≤ 32;
  the window of its range comes into shared memory by ``cp.async`` in two
  tiles used in turn. From 16 rows of B, where the FMAs weigh as much as
  the bytes, the plan aims at 2–3 smaller blocks an SM. float32
  accumulators, the bias added in float32, the cast at the store.
* Held back by: a launch's fixed cost (~4 µs: the cluster's barriers and
  the first window copy), near half of decoder 2's time at B 1; the
  weights stream at ~2 TB/s in 128-byte pieces of rows; from 16 rows the
  float32 FMAs and the window reads from shared memory set the time (bf16
  too: its products stay FMAs, not ``mma.sync``).

The plain version is ``ref.stmc_conv`` (re-exported here as ``plain``); a
CPU tensor takes it, a CUDA tensor launches the kernel or raises.
``stmc_conv.launches`` counts kernel launches. ``torch.addmm`` computes the
same function in one call; ``chip_smoke.py`` times it as a yardstick, and
the port never calls it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.stmc_conv

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

# blocks a B 1 conv aims at: one on each of the H100's 132 SMs
SM_COUNT = 132
# blocks a cluster: the portable cluster size, in powers of two
MAX_SPLITS = 8
# contraction rows a split holds at least (one pass of a block's row lanes
# at 16 bytes a thread)
MIN_SPLIT_ROWS = 16
# the widest column tile, in threads across a weight row (16 bytes each),
# and the narrowest: a 32-byte sector a row (16-byte pieces of a row take
# longer than half as many blocks of whole sectors: decoder 7, f32, B 1)
MAX_ROW_THREADS = 8
MIN_ROW_THREADS = 2
# rows of B a block holds at most
MAX_ROWS = 32
# rows of B from which a block's FMAs weigh as much as its bytes: then the
# plan aims at 2-3 blocks an SM (all resident at once: 128 threads, three
# blocks an SM), so that SMs with one more block than others wait less
FMA_ROWS = 16


class StmcPlan(NamedTuple):
    cols: int             # output columns a block
    splits: int           # blocks of a cluster, one range of K*Cin each
    keys_per_split: int   # rows of K*Cin a split (the last may hold fewer)
    rows: int             # rows of B a block
    blocks: int           # blocks of the launch
    vec16: bool           # 16-byte weight loads (else the masked edge path)


@functools.lru_cache(maxsize=256)
def stmc_plan(b: int, kc: int, cout: int, dtype) -> StmcPlan:
    """The launch of ``stmc_conv`` on a ``(b, kc) x (kc, cout)`` product of
    ``dtype`` (float32 or bfloat16). Split ``i`` of a cluster takes rows
    ``[i·keys_per_split, min(kc, (i+1)·keys_per_split))``, none empty.
    The column tile is the widest (of 8, 4, 2 sixteen-byte groups) that
    still gives ``SM_COUNT`` blocks at ``splits`` (from ``FMA_ROWS`` rows
    of B, where the FMAs weigh as much as the bytes, twice that); then
    ``splits`` is halved while the blocks pass what the SMs hold at once
    (two an SM, three from ``FMA_ROWS``)."""
    if min(b, kc, cout) < 1:
        raise ValueError(f"stmc_plan: b={b}, kc={kc}, cout={cout}")
    if dtype not in _DTYPES:
        raise TypeError(f"stmc_plan: {dtype} is not float32 or bfloat16")
    esz = torch.finfo(dtype).bits // 8
    group = 16 // esz
    splits = MAX_SPLITS
    while splits > 1 and kc < splits * MIN_SPLIT_ROWS:
        splits //= 2
    rows = min(MAX_ROWS, 1 << (b - 1).bit_length())
    fma = rows >= FMA_ROWS
    threads = MAX_ROW_THREADS
    while threads > MIN_ROW_THREADS and (-(-cout // (threads * group))
                                         * splits
                                         < (2 if fma else 1) * SM_COUNT):
        threads //= 2
    # every block resident at once: two an SM (three from FMA_ROWS)
    while splits > 1 and (-(-cout // (threads * group)) * splits
                          > (3 if fma else 2) * SM_COUNT):
        splits //= 2
    keys = -(-kc // splits)
    keys += keys % 2          # bf16 window pairs start on 4-byte boundaries
    cols = threads * group
    blocks = -(-cout // cols) * splits * -(-b // rows)
    return StmcPlan(cols, splits, keys, rows, blocks, cout * esz % 16 == 0)


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


@_build.metered("stmc_conv")
def stmc_conv(window, w, b=None):
    """window: (B, K, Cin); w: (K, Cin, Cout); b: (Cout,) or None. Returns
    ``window . w + b`` as (B, Cout) in the window's dtype, accumulated in
    float32."""
    if window.device.type == "cpu":
        return plain(window, w, b)
    if window.device.type != "cuda":
        raise ValueError(f"stmc_conv: unsupported device {window.device}")
    _build.refuse_grad("stmc_conv", window, w, b)
    _check_cuda(window, w, b)
    bsz, k, cin = window.shape
    y = _launch(window, w, b,
                stmc_plan(bsz, k * cin, w.shape[2], window.dtype))
    stmc_conv.launches += 1
    return y


stmc_conv.launches = 0


def _launch(window, w, b, plan: StmcPlan):
    """The kernel on checked CUDA tensors at ``plan`` (the wrapper's, or
    another for ``tools/stmc_plan_reading.py``)."""
    bsz, k, cin = window.shape
    cout = w.shape[2]
    y = torch.empty((bsz, cout), dtype=window.dtype, device=window.device)
    stream = torch.cuda.current_stream(window.device).cuda_stream
    rc = _build.library().repro_stmc_conv(
        window.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), bsz, k * cin, cout, plan.cols, plan.splits,
        plan.keys_per_split, plan.rows,
        _build.DTYPE_CODES[_DTYPES[window.dtype]], stream)
    _build.check(rc, "stmc_conv")
    return y
