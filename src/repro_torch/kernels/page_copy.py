"""Batched in-place page copy: the device half of copy-on-write.

Kernel: ``csrc/page_copy.cu`` (CUDA C++, sm_90a), which replaces the TPU
kernel ``repro/kernels/page_copy.py::copy_pages``.

* Bound on the H100: the bytes — one read and one write of every copied
  page. A COW flush copies a few pages per pool leaf, so a launch moves
  tens of KB and the launch itself dominates.
* Design: one launch per pool leaf copies the whole (n,) pair table; one
  block per pair moves the page's row with 16-byte vector loads and stores;
  ``src == dst`` pairs (the ``(0, 0)`` null-page padding) are skipped. The
  page allocator guarantees that no pair's ``dst`` is another pair's
  ``src`` (COW destinations are fresh pages), so one launch is race-free.
  The copy is bit-exact.
* Held back by: one launch per leaf — a flush over the qwen3 serving
  stack's 28 attention layers (k, v and pos each) is 84 launches.

The plain version is ``ref.copy_pages`` (re-exported here as ``plain``); a
CPU pool takes it, a CUDA pool launches the kernel or raises.
``copy_pages.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.copy_pages


def _check_cuda(pool, srcs, dsts):
    if pool.dim() < 1 or pool.shape[0] < 1:
        raise ValueError(f"pool {tuple(pool.shape)}: want (n_pages, ...)")
    if srcs.dim() != 1 or srcs.shape != dsts.shape:
        raise ValueError(f"srcs {tuple(srcs.shape)} / dsts "
                         f"{tuple(dsts.shape)}: want two (n,) vectors")
    if srcs.dtype != torch.int32 or dsts.dtype != torch.int32:
        raise TypeError("srcs and dsts must be int32")
    for name, t in (("pool", pool), ("srcs", srcs), ("dsts", dsts)):
        if t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, pool on "
                             f"{pool.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pool.data_ptr() % 16:
        raise ValueError("pool must be 16-byte aligned")


def copy_pages(pool, srcs, dsts):
    """pool: (n_pages, ...) any dtype, updated in place; srcs, dsts: (n,)
    int32 page ids in [0, n_pages). Applies ``pool[dsts[i]] =
    pool[srcs[i]]`` and returns ``pool``."""
    if pool.device.type == "cpu":
        return plain(pool, srcs, dsts)
    if pool.device.type != "cuda":
        raise ValueError(f"copy_pages: unsupported device {pool.device}")
    _check_cuda(pool, srcs, dsts)
    n = srcs.shape[0]
    if n == 0:
        return pool
    row_bytes = pool[0].numel() * pool.element_size()
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    rc = _build.library().repro_copy_pages(
        pool.data_ptr(), srcs.data_ptr(), dsts.data_ptr(), n, pool.shape[0],
        row_bytes, stream)
    _build.check(rc, "copy_pages")
    copy_pages.launches += 1
    return pool


copy_pages.launches = 0
