"""Gradient compression with error feedback (port of
``repro.optim.compression``): blockwise symmetric int8 quantization, the
residual carried in the optimizer state and added back the next step.
``compressed_grads`` simulates the wire quantization of a compressed
all-reduce (identical numerics and error-feedback dynamics), so the
optimizer path runs on one device."""

from __future__ import annotations

import torch

BLOCK = 256


def compress_int8(x: torch.Tensor, block: int = BLOCK):
    """Blockwise symmetric int8 quantization. Returns (q, scales)."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    block: int = BLOCK) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compressed_grads(grads: dict, error_state: dict | None):
    """int8 quantization with error feedback over a dict of grads. Returns
    (quantized-dequantized grads, new error state)."""
    if error_state is None:
        error_state = {k: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device)
                       for k, g in grads.items()}
    out, err = {}, {}
    for k, g in grads.items():
        corrected = g.float() + error_state[k]
        q, s = compress_int8(corrected)
        deq = decompress_int8(q, s, g.shape)
        out[k] = deq.to(g.dtype)
        err[k] = corrected - deq
    return out, err
