"""Griffin/RecurrentGemma recurrent block (port of ``repro.models.rglru``):
a gated conv branch and the RG-LRU.

    x -> [W_a -> GeLU] ------------------------------\\
    x -> [W_b -> causal conv1d(w=4) -> RG-LRU] -> (*) -> W_out

RG-LRU (diagonal, input- and recurrence-gated):
    r_t = sigmoid(W_r x_t)          i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(L) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence recurrence runs through ``kernels.ops.lru_scan`` (the
hand-written CUDA kernel on the card, its plain version on the CPU); the
gates, decay and input are float32, as in the reference. Decode carries
O(1) state per slot — ``h`` (B, w) in float32 and the conv window ``conv``
(B, conv_width-1, w) of pre-conv inputs in the compute dtype — and updates
it in place, only in the ``commit`` rows when a mask is given (the SOI
middle commits only slots whose compression window is complete).

Under ``layers.model_parallel`` the block runs on the rank's shard of the
w channels (``ff``; the gates' blocks on ``heads``): x passes ``to_model``
before ``wa`` and ``wb``, the conv, gates, decay and scan act on the w/M
local channels (so do the decode state's ``h`` and ``conv``), and the
output projection's partial sums add up over the model axis
(``from_model``). The head count and the widths are the weights'. On a
sequence shard (``layers.seq_sharded``) the full-sequence forward gathers
x first and scatters the sum onto the rank's rows (``act_to_model`` /
``act_from_model``): the scan sees the whole sequence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RGLRUCfg
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import act_from_model, act_to_model, \
    dense_init, from_model, param, to_model
from repro_torch.models.mlp import gelu

_C = 8.0


class RGLRU(nn.Module):
    """RG-LRU weights (the reference's ``rglru_init``) in its layout:
    ``wa``/``wb`` (d, w), ``conv`` (conv_width, w), ``conv_b`` (w,), the
    block-diagonal gates ``wr``/``wi`` (nh, w/nh, w/nh) with biases
    ``br``/``bi`` (w,), ``lam`` (w,) and ``wo`` (w, d)."""

    def __init__(self, cfg: RGLRUCfg, d: int, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        w = cfg.width or d
        nh = cfg.n_heads or 1
        bw = w // nh
        k = cfg.conv_width
        kw = dict(generator=generator, device=device, dtype=dtype)
        zeros = dict(device=device, dtype=dtype)
        param(self, "wa", dense_init((d, w), **kw), ("embed", "ff"))
        param(self, "wb", dense_init((d, w), **kw), ("embed", "ff"))
        param(self, "conv", dense_init((k, w), scale=k ** -0.5, **kw),
              ("conv_k", "ff"))
        param(self, "conv_b", torch.zeros(w, **zeros), ("ff",))
        for name in ("wr", "wi"):
            param(self, name, dense_init((nh, bw, bw), **kw),
                  ("heads", "head_dim", "head_dim"))
        param(self, "br", torch.zeros(w, **zeros), ("ff",))
        param(self, "bi", torch.zeros(w, **zeros), ("ff",))
        # Lambda so that a = exp(-c * softplus(lam)) spans (0.9, 0.999)
        a = torch.linspace(0.9, 0.999, w, device=device)
        param(self, "lam", torch.log(torch.expm1(-torch.log(a) / _C))
              .to(dtype), ("ff",))
        param(self, "wo", dense_init((w, d), **kw), ("ff", "embed"))


def _gates(p: RGLRU, xb: torch.Tensor, nh: int):
    """Block-diagonal input and recurrence gates, float32."""
    lead, w = xb.shape[:-1], xb.shape[-1]
    xh = xb.reshape(*lead, nh, w // nh)
    r = torch.einsum("...hk,hkj->...hj", xh, p.wr).reshape(*lead, w) + p.br
    i = torch.einsum("...hk,hkj->...hj", xh, p.wi).reshape(*lead, w) + p.bi
    return torch.sigmoid(r.float()), torch.sigmoid(i.float())


def _a_and_b(p: RGLRU, xb: torch.Tensor, nh: int):
    """Per-timestep decay a_t and input b_t of the diagonal recurrence
    (float32)."""
    r, i = _gates(p, xb, nh)
    log_a = -_C * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, gated * i * xb.float()


def rglru_forward(p: RGLRU, x: torch.Tensor):
    """Full-sequence forward, x (B, S, d) -> (y (B, S, d), state): the
    recurrence state ``rglru_decode`` carries — ``h`` (B, w) float32 after
    the last step, and ``conv``, the last conv_width-1 pre-conv inputs
    (zero-padded as the streaming window is for S < conv_width-1) — so
    decode resumes at position S."""
    nh = p.wr.shape[0]
    x = act_to_model(x)
    s = x.shape[1]
    ga = gelu(torch.matmul(x, p.wa))
    xb = torch.matmul(x, p.wb)
    k = p.conv.shape[0]
    xp = F.pad(xb, (0, 0, k - 1, 0))
    xc = sum(xp[:, i:s + i] * p.conv[i] for i in range(k)) + p.conv_b
    a, bx = _a_and_b(p, xc, nh)
    h, h_last = kops.lru_scan(a.contiguous(), bx.contiguous())
    y = act_from_model(torch.matmul(h.to(x.dtype) * ga, p.wo))
    # a copy: the state must not keep the whole (B, S, w) scan alive
    return y, {"h": h_last.to(torch.float32, copy=True),
               "conv": xp[:, s:].contiguous()}


def rglru_init_state(p: RGLRU, batch: int, dtype, device) -> dict:
    """Empty decode state of the block ``p``: ``h`` float32 (whatever the
    compute dtype) and the conv window in ``dtype``, as wide as the
    block's channels (a tensor-parallel shard's w/M)."""
    k, w = p.conv.shape
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, k - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(p: RGLRU, x: torch.Tensor, state: dict, *, commit=None):
    """One token per slot, x (B, d) -> y (B, d). Updates ``state`` in place;
    with ``commit`` ((B,) bool) only its True rows take the new ``h`` and
    conv window, the others keep theirs."""
    nh = p.wr.shape[0]
    x = to_model(x)
    ga = gelu(torch.matmul(x, p.wa))
    xb = torch.matmul(x, p.wb)
    window = torch.cat([state["conv"], xb[:, None]], dim=1)
    xc = torch.einsum("bkw,kw->bw", window, p.conv) + p.conv_b
    a, bx = _a_and_b(p, xc, nh)
    h = a * state["h"] + bx
    y = from_model(torch.matmul(h.to(x.dtype) * ga, p.wo))
    conv = window[:, 1:]
    if commit is not None:
        h = torch.where(commit[:, None], h, state["h"])
        conv = torch.where(commit[:, None, None], conv, state["conv"])
    state["h"].copy_(h)
    state["conv"].copy_(conv)
    return y
