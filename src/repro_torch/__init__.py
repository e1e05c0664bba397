"""``repro_torch`` — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The module layout mirrors ``repro`` so each file has one counterpart. The
package imports ``torch`` only: configs, the model, the serving engine and
the hand-written CUDA kernels under ``kernels/csrc`` are its own.

Entry points run on the card by default. ``resolve_device`` is the one rule:
``None``/``"cuda"`` means the GPU and raises when there is none; the CPU is
used only when the caller asks for it (the tests do, and then every kernel
takes its plain PyTorch version).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None -> "cuda") as a ``torch.device``; raises if a CUDA
    device was asked for and the machine has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
