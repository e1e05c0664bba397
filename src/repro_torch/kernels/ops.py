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

``gather_pages`` (prefix-cache hydration) has no TPU kernel in the
reference either: it is a plain PyTorch gather on every device. Nor has
``mla_decode_attention``, the absorbed-MLA read of a dense latent cache
("reference path on every backend", ``repro/kernels/ops.py``): it is the
plain PyTorch version on the card too. Nor has sliding-window prefill
attention: the reference's ``ops.flash_attention`` sends a ``window`` to
``ref.windowed_flash_attention`` (or ``chunked_flash_attention``) on every
backend, the TPU included, because its Pallas flash kernel takes no
window. ``flash_attention`` here does the same: a window goes to the plain
``ref.windowed_flash_attention`` on every device, and the CUDA flash kernel
runs only unwindowed prefill.
"""

from __future__ import annotations

from repro_torch.kernels.chunk_attention import (chunk_attention,
                                                 mla_chunk_attention)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention,
                                                  paged_mla_decode_attention)
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels.lru_scan import lru_scan
from repro_torch.kernels.page_copy import copy_pages
from repro_torch.kernels.ref import gather_pages, mla_decode_attention
from repro_torch.kernels.stmc_conv import stmc_conv

KERNELS = (decode_attention, _flash.flash_attention, chunk_attention,
           paged_decode_attention, copy_pages, mla_chunk_attention,
           paged_mla_decode_attention, lru_scan, stmc_conv)


def flash_attention(q, k, v, *, causal=True, window=None, prefix_len=0,
                    q_offset=0, scale=None, logit_softcap=None):
    """Whole-prompt prefill attention: the ``flash_attention`` kernel, or —
    with a ``window`` — the plain ``ref.windowed_flash_attention`` on every
    device (the reference has no windowed kernel either)."""
    if window is None:
        return _flash.flash_attention(
            q, k, v, causal=causal, prefix_len=prefix_len, q_offset=q_offset,
            scale=scale, logit_softcap=logit_softcap)
    if not causal or prefix_len:
        raise ValueError("windowed attention is causal, without a prefix")
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


__all__ = ["chunk_attention", "copy_pages", "decode_attention",
           "flash_attention", "gather_pages", "launch_counts", "lru_scan",
           "mla_chunk_attention", "mla_decode_attention",
           "paged_decode_attention", "paged_mla_decode_attention",
           "reset_launch_counts", "stmc_conv"]
