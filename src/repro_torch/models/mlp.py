"""Channel mixer (port of the SwiGLU path of ``repro.models.mlp``), with
weights in the reference's einsum layout ``up/gate (d, d_ff)``,
``down (d_ff, d)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MLPCfg
from repro_torch.models.layers import dense_init


class MLP(nn.Module):
    def __init__(self, cfg: MLPCfg, d: int, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        if cfg.kind != "swiglu":
            raise NotImplementedError(
                f"mlp kind {cfg.kind!r} is not ported yet; see ROADMAP.md")
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.up = nn.Parameter(dense_init((d, cfg.d_ff), **kw))
        self.down = nn.Parameter(dense_init((cfg.d_ff, d), **kw))
        self.gate = nn.Parameter(dense_init((d, cfg.d_ff), **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> (..., d)."""
    h = torch.matmul(x, p.up)
    h = h * F.silu(torch.matmul(x, p.gate))
    return torch.matmul(h, p.down)
