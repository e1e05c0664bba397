"""Channel mixer (port of ``repro.models.mlp``): the gated SwiGLU and
GeGLU, and the plain squared-ReLU (nemotron) and GeLU, with weights in the
reference's einsum layout ``up (d, d_ff)``, ``down (d_ff, d)`` and — gated
kinds only — ``gate (d, d_ff)``. GeLU is the tanh approximation, as
``jax.nn.gelu`` computes it by default (PyTorch's default is the erf
form)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MLPCfg
from repro_torch.models.layers import act_from_model, act_to_model, \
    dense_init, param
from repro_torch.models.remat import checkpoint_name


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def relu2(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (nemotron's channel mixer)."""
    return torch.square(F.relu(x))


GATED = {"swiglu": F.silu, "geglu": gelu}
PLAIN = {"relu2": relu2, "gelu": gelu}


class MLP(nn.Module):
    def __init__(self, cfg: MLPCfg, d: int, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        if cfg.kind not in GATED and cfg.kind not in PLAIN:
            raise NotImplementedError(
                f"mlp kind {cfg.kind!r} is not ported yet; see ROADMAP.md")
        kw = dict(generator=generator, device=device, dtype=dtype)
        param(self, "up", dense_init((d, cfg.d_ff), **kw), ("embed", "ff"))
        param(self, "down", dense_init((cfg.d_ff, d), **kw), ("ff", "embed"))
        self.gated = cfg.kind in GATED
        if self.gated:
            param(self, "gate", dense_init((d, cfg.d_ff), **kw),
                  ("embed", "ff"))
        self.act = GATED[cfg.kind] if self.gated else PLAIN[cfg.kind]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> (..., d); under ``layers.model_parallel`` on the
    shard's ff columns, summed over the model axis (a sequence shard's x
    gathered, the sum scattered onto its rows: ``act_to_model`` /
    ``act_from_model``). The hidden is tagged ``"ffn_hidden"``
    (``remat.checkpoint_name``)."""
    x = act_to_model(x)
    h = torch.matmul(x, p.up)
    if p.gated:
        h = h * p.act(torch.matmul(x, p.gate))
    else:
        h = p.act(h)
    # what remat_policy="names" saves (the reference's checkpoint_name)
    h = checkpoint_name(h, "ffn_hidden")
    return act_from_model(torch.matmul(h, p.down))
