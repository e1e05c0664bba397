"""The kernel layer as the model sees it: every kernel wrapper of the
port, and their launch counters.

Each wrapper dispatches by the tensor's device: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
kernel or raises. There is no switch that sends a CUDA tensor to the plain
version and no fallback after a failed launch: callers that want the plain
result on the card call ``kernels.ref`` directly (``chip_smoke.py`` does).
The model code reaches the kernels only through this module: the LM
path's attention, page copy and RG-LRU scan, and the streaming U-Net's
STMC conv contraction (``stmc_conv``, every computed conv of every frame).
Training reaches two backward kernels through autograd:
``flash_attention``'s, ``flash_attention_bwd``, and ``lru_scan``'s,
``lru_scan_bwd``; every other kernel's CUDA route raises
``NotImplementedError`` when grad mode is on and an input requires grad (a
host check of flags).

``gather_pages`` (prefix-cache hydration) has no TPU kernel in the
reference either: it is a plain PyTorch gather on every device. Nor has
``mla_decode_attention``, the absorbed-MLA read of a dense latent cache
("reference path on every backend", ``repro/kernels/ops.py``): it is the
plain PyTorch version on the card too, its ``return_lse`` (the partial
read of a latent ring split over the model axis) included. Nor has ``merge_partials``, the
merge in rank order of the partial reads (``decode_attention(...,
return_lse=True)``) of a KV sequence split over the model axis: the
reference leaves that merge to XLA's partitioner, so here it is a plain
PyTorch float32 sum on every device. Nor has sliding-window prefill
attention: the reference's ``ops.flash_attention`` sends a ``window`` to
``ref.windowed_flash_attention`` (or ``chunked_flash_attention``) on every
backend, the TPU included, because its Pallas flash kernel takes no
window. ``flash_attention`` here does the same: a window goes to the plain
``ref.windowed_flash_attention`` on every device, and a gradient
through it is autograd's of that plain function, as the reference's is
XLA's. Nor has prefix-LM prefill: the reference sends a ``prefix_len >
0`` to its plain ``ref.chunked_flash_attention`` on every backend, the TPU
included, and differentiates it with XLA; here it goes to the plain
``ref.flash_attention`` on every device, and a gradient through it is
autograd's of that plain function (the prefix-LM's training, paligemma's,
on the card too). These two routes are the reference's own, not
fallbacks: no TPU kernel computes windowed or prefix-LM attention. The
CUDA flash kernel runs only causal or full prefill with neither.
"""

from __future__ import annotations

from repro_torch.kernels.chunk_attention import (chunk_attention,
                                                 mla_chunk_attention)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention,
                                                  paged_mla_decode_attention)
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels.lru_scan import lru_scan, lru_scan_bwd
from repro_torch.kernels.page_copy import copy_pages, copy_pages_leaves
from repro_torch.kernels.ref import (gather_pages, merge_partials,
                                    mla_decode_attention)
from repro_torch.kernels.stmc_conv import stmc_conv

flash_attention_bwd = _flash.flash_attention_bwd

KERNELS = (decode_attention, _flash.flash_attention, chunk_attention,
           paged_decode_attention, copy_pages, mla_chunk_attention,
           paged_mla_decode_attention, lru_scan, stmc_conv,
           flash_attention_bwd, lru_scan_bwd)
_BY_NAME = {k.__name__: k for k in KERNELS}


def flash_attention(q, k, v, *, causal=True, window=None, prefix_len=0,
                    q_offset=0, scale=None, logit_softcap=None):
    """Whole-prompt prefill attention: the ``flash_attention`` kernel, or —
    with a ``window`` or a ``prefix_len > 0`` — the plain
    ``ref.windowed_flash_attention`` or ``ref.flash_attention`` on every
    device, as the reference routes them (it has no kernel for either).
    With grad mode on and an input that requires grad, the card runs the
    kernel with its CUDA backward (``flash_attention_bwd``), and the
    windowed and prefix routes are differentiated by autograd, as the
    reference's plain routes are by XLA."""
    if window is None and not prefix_len:
        return _flash.flash_attention(
            q, k, v, causal=causal, q_offset=q_offset, scale=scale,
            logit_softcap=logit_softcap)
    if window is not None and (not causal or prefix_len):
        raise ValueError("windowed attention is causal, without a prefix")
    if window is None:
        return ref.flash_attention(q, k, v, causal=causal,
                                   prefix_len=prefix_len, q_offset=q_offset,
                                   scale=scale, logit_softcap=logit_softcap)
    return ref.windowed_flash_attention(q, k, v, window=window,
                                        q_offset=q_offset, scale=scale,
                                        logit_softcap=logit_softcap)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return {k.__name__: k.launches for k in KERNELS}


def add_launch_counts(delta: dict) -> None:
    """Add ``{kernel name: n}`` to the launch counters (n may be negative).
    A replayed CUDA graph launches its kernels without reaching their
    wrappers: ``engine.contracts.CheckedGraph`` takes back the launches its
    capture counted and adds them again at every replay."""
    for name, n in delta.items():
        _BY_NAME[name].launches += n


__all__ = ["add_launch_counts", "chunk_attention", "copy_pages",
           "copy_pages_leaves", "decode_attention", "flash_attention",
           "flash_attention_bwd",
           "gather_pages",
           "launch_counts", "lru_scan", "lru_scan_bwd", "merge_partials",
           "mla_chunk_attention",
           "mla_decode_attention", "paged_decode_attention",
           "paged_mla_decode_attention", "reset_launch_counts", "stmc_conv"]
