"""AdamW with decoupled weight decay (port of ``repro.optim.adamw``).
Moments are float32 and keyed like the parameters; ``count`` is an int32
0-d tensor on the parameters' device, so the bias corrections are computed
there and a step reads nothing back to the host.

Unlike the reference, which returns new arrays, ``adamw_update`` writes the
float32 masters and the moments in place, leaf by leaf (at qwen3-1.7b's
1.7 B parameters a second copy of either would cost 7 GB), with the
reference's formula and order of operations."""

from __future__ import annotations

import torch


def adamw_init(params: dict) -> dict:
    """Zero float32 moments laid out like each parameter (a DTensor
    parameter's moments are DTensors of its placements) and ``count``."""
    dev = next(iter(params.values())).device
    return {
        "mu": {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
        "nu": {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """Returns (params, opt_state), both updated in place (``count`` is
    replaced by ``count + 1``). ``lr`` may be a number or a 0-d tensor (a
    schedule value computed by the caller from ``opt_state["count"]``)."""
    count = opt_state["count"] + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(b1, cf)
    bc2 = 1.0 - torch.pow(b2, cf)
    for k, g in grads.items():
        p, m, v = params[k], opt_state["mu"][k], opt_state["nu"][k]
        g = g.float()
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * torch.square(g))
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.float()
        p.copy_(pf - lr * (step + weight_decay * pf))
    opt_state["count"] = count
    return params, opt_state
