"""Async, atomic checkpointing with restore onto any device (port of
``repro.checkpoint.checkpointer``; the same on-disk layout).

* **Atomic**: a step is written under ``<dir>/tmp.<step>`` and renamed to
  ``<dir>/step_<step:08d>`` only after every array and the manifest are
  fsync'd, so a crash mid-save never corrupts the latest checkpoint.
* **Async**: ``Checkpointer.save_async`` copies every tensor to host
  memory *before it returns* and hands only that copy to a background
  thread. The port updates masters and moments in place (the reference's
  JAX arrays are immutable), so the thread must never read live tensors.
* **Elastic**: arrays are stored whole, with their tree paths; ``restore``
  puts them on whatever device the caller names.
* Manifest: JSON with the step and, per array, its tree path, file, shape,
  dtype and crc32.

A tree is nested dicts (and lists) of tensors, numpy arrays or
``nn.Module``s; a module contributes its ``state_dict`` entries under its
path (``['params']['blocks.0.attn.wq']``), 0-d tensors included. Dict keys
are walked in sorted order, as JAX flattens them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch
from torch import nn


def _walk(tree, path: str = ""):
    """(path, leaf) pairs of a tree, in a fixed order."""
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict().items():
            yield f"{path}['{name}']", t
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    """A host copy that shares no memory with ``leaf``."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu().numpy()
    return np.array(leaf, copy=True)


def _snapshot(tree) -> list:
    """[(path, numpy copy)] of every leaf: what a save writes."""
    return [(p, _host(leaf)) for p, leaf in _walk(tree)]


def _write(directory: str, step: int, leaves: list) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": []}
    for i, (p, arr) in enumerate(leaves):
        fname = f"arr_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["arrays"].append({
            "path": p, "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(directory: str, step: int, tree) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    return _write(directory, step, _snapshot(tree))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, step: int, target_tree, *, device=None,
            verify: bool = True):
    """Restore into the structure of ``target_tree``: tensors come back on
    ``device`` (default: the target leaf's device), a module is loaded in
    place (moved to ``device`` first if given) and returned."""
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {a["path"]: a for a in manifest["arrays"]}

    def load(path, leaf):
        meta = by_path[path]
        arr = np.load(os.path.join(final, meta["file"]))
        if verify and (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF) != meta["crc"]:
            raise IOError(f"checksum mismatch for {path}")
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {path}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        if not torch.is_tensor(leaf):
            return arr
        return torch.from_numpy(arr).to(
            leaf.device if device is None else device)

    def rebuild(tree, path):
        if isinstance(tree, nn.Module):
            if device is not None:
                tree.to(device)
            tree.load_state_dict({name: load(f"{path}['{name}']", t)
                                  for name, t in tree.state_dict().items()})
            return tree
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{path}['{k}']") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{path}[{i}]")
                              for i, v in enumerate(tree))
        return load(path, tree)

    return rebuild(target_tree, "")


class Checkpointer:
    """Async checkpoint manager with a single inflight save."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree):
        """Copy ``tree`` to host memory now, then write that copy in a
        background thread: the caller may update ``tree`` in place as soon
        as this returns."""
        self.wait()
        leaves = _snapshot(tree)

        def work():
            _write(self.directory, step, leaves)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest(self):
        return latest_step(self.directory)

    def restore_latest(self, target_tree, device=None):
        step = self.latest()
        if step is None:
            return None, None
        return step, restore(self.directory, step, target_tree,
                             device=device)

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
