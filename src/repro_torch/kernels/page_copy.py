"""Batched in-place page copy: the device half of copy-on-write.

Kernel: ``csrc/page_copy.cu`` (CUDA C++, sm_90a), which replaces the TPU
kernel ``repro/kernels/page_copy.py::copy_pages``.

* Bound on the H100: the bytes — one read and one write of every copied
  page. A COW flush over qwen3's 28 attention layers (k, v and pos each)
  with 4 pairs a table moves ~14.7 MB, ~4.4 µs at 3.35 TB/s: fixed costs
  (launches, host calls, uploads) decide its time.
* Design: one launch a flush. :func:`copy_pages_leaves` takes every pool
  leaf of the flush with its pair list, packs one int64 table on the host
  (:func:`pack_leaves`: each leaf's pointer, row bytes, pages and the
  offset and count of its pairs, then the pairs), uploads it in one copy
  from pinned memory and launches once; block (p, l) copies pair p of leaf
  l in 16-byte vectors where the leaf allows. ``src == dst`` pairs (the
  ``(0, 0)`` null-page padding) and ids outside ``[0, n_pages)`` are
  skipped. The page allocator guarantees that no pair's ``dst`` is another
  pair's ``src`` (COW destinations are fresh pages), so the launch is
  race-free. The copy is bit-exact. :func:`copy_pages` is its one-leaf
  case.
* Held back by: the host packs and uploads a table a flush; a block per
  pair, idle where a leaf has fewer pairs than the most.

The plain version is ``ref.copy_pages`` (re-exported here as ``plain``); a
CPU pool takes it, a CUDA pool launches the kernel or raises.
``copy_pages.launches`` counts kernel launches (one a
``copy_pages_leaves`` call).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.copy_pages

# fields of a leaf's record in the packed table
FIELDS = ("base", "row_bytes", "pages", "pair_offset", "pairs")


def _host_ids(ids) -> np.ndarray:
    """Page ids as a host int64 vector: a sequence, a numpy array or an
    int32 tensor (a CUDA tensor is read back, which waits for the card)."""
    if torch.is_tensor(ids):
        if ids.dtype != torch.int32:
            raise TypeError(f"page ids must be int32, got {ids.dtype}")
        ids = ids.cpu().numpy()
    ids = np.asarray(ids)
    if ids.size and ids.dtype.kind not in "iu":
        raise TypeError(f"page ids must be integers, got {ids.dtype}")
    return ids.astype(np.int64, copy=False).reshape(-1)


def pack_leaves(pools, srcs, dsts) -> np.ndarray:
    """The int64 table of one launch: ``len(pools)`` records of
    :data:`FIELDS` in leaf order (the pool's ``data_ptr()``, the bytes of
    one page, its pages, where its pairs start among all pairs and how many
    it has), then the ``(src, dst)`` pairs, padding pairs kept. Leaves
    given the same pair lists (the same objects, as the engine gives every
    leaf of a page table) share one copy of them."""
    if not len(pools) == len(srcs) == len(dsts):
        raise ValueError(f"{len(pools)} pools, {len(srcs)} srcs and "
                         f"{len(dsts)} dsts lists")
    heads, chunks, where, off = [], [], {}, 0
    for pool, s, d in zip(pools, srcs, dsts):
        key = (id(s), id(d))
        at = where.get(key)
        if at is None:
            hs, hd = _host_ids(s), _host_ids(d)
            if hs.shape != hd.shape:
                raise ValueError(f"srcs {hs.shape} / dsts {hd.shape}: want "
                                 f"one length")
            at = where[key] = (off, hs.size)
            chunks.append(np.stack([hs, hd], 1).reshape(-1))
            off += hs.size
        n = pool.shape[0]
        heads += (pool.data_ptr(), pool.nbytes // n, n, *at)
    return np.concatenate([np.asarray(heads, np.int64)] + chunks)


def _upload(table: np.ndarray, dev) -> torch.Tensor:
    """The packed table on ``dev``, by one copy from a fresh pinned buffer:
    the caching host allocator keeps the buffer until the copy has run, so
    the upload never waits for the card."""
    return torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)


@_build.metered("copy_pages")
def copy_pages_leaves(pools, srcs, dsts):
    """pools: pool leaves (n_pages, ...) of any dtype on one device, updated
    in place; srcs, dsts: one pair list per pool (page ids in [0, n_pages);
    sequences, numpy arrays or int32 tensors). Applies ``pool[dsts[i]] =
    pool[srcs[i]]`` to every pool in one launch; returns ``pools``."""
    if not pools:
        return pools
    dev = pools[0].device
    if dev.type == "cpu":
        for pool, s, d in zip(pools, srcs, dsts, strict=True):
            plain(pool, torch.from_numpy(_host_ids(s)),
                  torch.from_numpy(_host_ids(d)))
        return pools
    if dev.type != "cuda":
        raise ValueError(f"copy_pages: unsupported device {dev}")
    _build.refuse_grad("copy_pages", *pools)
    for i, pool in enumerate(pools):
        if pool.device != dev or not pool.is_contiguous() or (
                pool.dim() < 1 or pool.shape[0] < 1):
            raise ValueError(f"pool {i} {tuple(pool.shape)} on "
                             f"{pool.device}: want contiguous (n_pages, ...) "
                             f"pools on {dev}")
    table = pack_leaves(pools, srcs, dsts)
    counts = table[4:len(pools) * len(FIELDS):len(FIELDS)]
    if not counts.any():
        return pools
    table = _upload(table, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.library().repro_copy_pages(
        table.data_ptr(), len(pools), int(counts.max()), stream)
    _build.check(rc, "copy_pages")
    copy_pages.launches += 1
    return pools


def copy_pages(pool, srcs, dsts):
    """pool: (n_pages, ...) any dtype, updated in place; srcs, dsts: (n,)
    page ids in [0, n_pages), as :func:`copy_pages_leaves` takes them.
    Applies ``pool[dsts[i]] = pool[srcs[i]]`` and returns ``pool``: the
    one-leaf case of :func:`copy_pages_leaves`."""
    copy_pages_leaves([pool], [srcs], [dsts])
    return pool


copy_pages.launches = 0
