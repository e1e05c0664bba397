"""Mixture-of-Experts with sort-based capacity dispatch (port of
``repro.models.moe``), with weights in the reference's einsum layout:
``router (d, E)``, ``up/gate (E, d, d_expert)``, ``down (E, d_expert, d)``
and the shared experts' ``shared_up/shared_gate (d, w)``, ``shared_down
(w, d)``.

Dispatch is the reference's, step for step, so the same tokens are kept
and dropped:

1. tokens split into ``r = gcd(T, dispatch_groups)`` groups of ``tg``;
   each group routes on its own with capacity
   ``cap = max(k, int(tg * k / E * capacity_factor))``;
2. router top-k -> (token, expert, weight) triples, sorted by expert with a
   *stable* sort (``jnp.argsort`` is stable), the position in its expert
   from ``searchsorted`` of the segment starts;
3. entries at or past ``cap`` are dropped; the kept ones scatter-add into
   an ``(r, E, cap, d)`` buffer;
4. the expert products run batched over every expert (plain large matrix
   products, which the reference leaves to XLA and the port to
   ``torch.matmul``), gather back, weighted combine, plus the shared
   experts.

The reference runs every expert on every step: ``(r, E, cap, d)`` holds
zeros for an expert no token chose, and its weights are read all the same.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoECfg
from repro_torch.models.layers import (act_from_model, act_to_model,
                                       data_size, dense_init, from_model,
                                       gather_from_model, model_rank, param,
                                       reduce_from_data)


class MoE(nn.Module):
    def __init__(self, cfg: MoECfg, d: int, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        if cfg.mlp_kind != "swiglu":
            raise NotImplementedError(
                f"MoE expert kind {cfg.mlp_kind!r} is not ported yet; see "
                f"ROADMAP.md")
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        e, f = cfg.n_experts, cfg.d_expert
        experts = ("experts", "embed", "expert_ff")
        param(self, "router", dense_init((d, e), scale=d ** -0.5, **kw),
              ("embed", "experts"))
        param(self, "up", dense_init((e, d, f), **kw), experts)
        param(self, "down", dense_init((e, f, d), scale=f ** -0.5, **kw),
              ("experts", "expert_ff", "embed"))
        param(self, "gate", dense_init((e, d, f), **kw), experts)
        if cfg.n_shared:
            w = cfg.n_shared * (cfg.d_shared or cfg.d_expert)
            param(self, "shared_up", dense_init((d, w), **kw),
                  ("embed", "ff"))
            param(self, "shared_down", dense_init((w, d), scale=w ** -0.5,
                                                  **kw), ("ff", "embed"))
            param(self, "shared_gate", dense_init((d, w), **kw),
                  ("embed", "ff"))


def _experts(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its rows: buf (r, E, cap, d) ->
    (r, E, cap, d)."""
    r, e, cap, d = buf.shape
    xb = buf.permute(1, 0, 2, 3).reshape(e, r * cap, d)
    h = torch.bmm(xb, p.up) * F.silu(torch.bmm(xb, p.gate))
    out = torch.bmm(h, p.down)
    return out.reshape(e, r, cap, d).permute(1, 0, 2, 3)


def _shared(p: MoE, x: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, p.shared_up) * F.silu(torch.matmul(x,
                                                           p.shared_gate))
    return torch.matmul(h, p.shared_down)


def moe_apply(p: MoE, x: torch.Tensor, *, capacity: int | None = None,
              dispatch_groups: int = 32, with_aux: bool = True):
    """x: (B, S, d) or (T, d). Returns (y, aux_loss); ``aux_loss`` is the
    reference's switch load-balancing term, a float32 scalar over the
    call's global routing statistics (training adds it to the loss), or
    None with ``with_aux=False`` (serving, which skips its kernels).

    Expert parallelism (inside ``layers.model_parallel``, the router's
    columns and the experts split over the model axis; inside
    ``layers.data_parallel``, the rows over the data axes): the groups
    are the global batch's — ``r = gcd(T_global, dispatch_groups)`` with
    ``T_global`` the local count times the data ranks', so this data
    rank's tokens are groups ``[d r/D, (d+1) r/D)`` (the rows are
    batch-major and contiguous) — and every model rank routes on the same
    logits, gathered to all E experts. The sort, the positions and the
    drops are the unsharded ones over all E; a rank then scatters,
    computes and combines only its own experts' entries, adds its share
    of the shared experts' split ``ff``, and one ``from_model`` sums the
    ranks' partial outputs. The aux loss takes the routing statistics
    summed over the data ranks; each model rank adds its own experts'
    terms, and ``from_model`` sums them, so the logits' gather-backward
    counts its gradient once. A sequence shard's x is gathered first and
    the sum scattered back onto its rows (``act_to_model`` /
    ``act_from_model``), so the groups are the whole sequence's. Outside
    these regions every hook is the identity and this is the reference's
    computation, op for op."""
    cfg = p.cfg
    x = act_to_model(x)
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    n_data = data_size()
    r = math.gcd(t * n_data, dispatch_groups)     # the global batch's
    if r % n_data:
        raise NotImplementedError(
            f"MoE dispatch: {r} groups of the global batch's {t * n_data} "
            f"tokens do not split over {n_data} data ranks (ROADMAP.md, "
            f"Queue 1 item 8)")
    tg = t * n_data // r                          # tokens per group
    r //= n_data                                  # this rank's groups
    cap = capacity or max(k, int(tg * k / e * cfg.capacity_factor))
    m, n_model = model_rank()
    el = e // n_model                             # this rank's experts
    e0 = m * el
    dev = x.device

    xg = xt.reshape(r, tg, d)
    logits = gather_from_model(torch.matmul(xg, p.router).float(), -1)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)   # (r, tg, k), descending

    aux = None
    if with_aux:
        assign = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
            0, top_i.reshape(-1),
            torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                       device=dev))
        mean = probs.mean(dim=(0, 1))
        if n_data > 1:
            # the data ranks' equal shares of the global statistics
            assign = reduce_from_data(assign) / n_data
            mean = reduce_from_data(mean) / n_data
        aux = from_model(cfg.router_aux_weight * e * torch.sum(
            assign[e0:e0 + el] * mean[e0:e0 + el]))

    flat_e = top_i.reshape(r, tg * k)
    flat_tok = torch.arange(tg, device=dev).repeat_interleave(k)[None] \
        .expand(r, tg * k)
    flat_w = top_w.reshape(r, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = torch.gather(flat_tok, 1, order)
    sw = torch.gather(flat_w, 1, order)
    starts = torch.searchsorted(se, torch.arange(e, device=dev)
                                .expand(r, e).contiguous())
    pos = torch.arange(tg * k, device=dev)[None] - torch.gather(starts, 1,
                                                                 se)
    keep = pos < cap
    posc = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    if el < e:
        # only this rank's experts' entries: the others weigh 0 in its
        # buffer and its combine
        mine = (se >= e0) & (se < e0 + el)
        keep = keep & mine
        se = torch.where(mine, se - e0, torch.zeros_like(se))

    rows = torch.arange(r, device=dev)[:, None].expand(r, tg * k)
    g = xg[rows, stok] * keep[..., None].to(xt.dtype)
    buf = torch.zeros((r, el, cap, d), dtype=xt.dtype, device=dev)
    buf.index_put_((rows, se, posc), g, accumulate=True)

    out_buf = _experts(p, buf)
    back = out_buf[rows, se, posc] * (keep * sw).to(xt.dtype)[..., None]
    y = torch.zeros((r, tg, d), dtype=xt.dtype, device=dev)
    y.index_put_((rows, stok), back, accumulate=True)
    y = y.reshape(t, d)
    if cfg.n_shared:
        y = y + _shared(p, xt)
    return act_from_model(y.reshape(shape)), aux
