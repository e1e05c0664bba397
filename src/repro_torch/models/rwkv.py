"""RWKV-6 ("Finch") — attention-free time mixing with data-dependent decay
(port of ``repro.models.rwkv``).

Per head (k/v dims dh): state S in R^{dh x dh};
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(wlog_t))
with token-shift data-dependent mixing on every projection input and a
decay LoRA producing per-channel w_t.

Prefill uses the *chunked* parallel form (chunks of 32, the sequence padded
to a multiple): intra-chunk pair terms exp(cumlog[t-1] - cumlog[s]) are
always <= 1 (clipped at -60 in log space), so the form is safe for any
decay. The wkv runs in float32 and its output returns to the model dtype
before the per-head group norm, in the reference's order of operations.
Decode is the O(1) recurrence; its state is ``x_prev`` (B, d) in the model
dtype and ``S`` (B, h, dh, dh) in float32, updated in place (only the
``commit`` rows when a mask is given, as the RG-LRU's).

Channel mix (the RWKV FFN): r = sigmoid(W_r x_r); y = r * (W_v relu(W_k
x_k)^2).

rwkv has no TPU kernel in the reference: every product here is plain
PyTorch on every device.

Tensor parallelism (``layers.model_parallel`` over M ranks), the
reference's layout: ``wr``, ``wk``, ``wv``, ``wg``, ``cm_k`` and ``cm_r``
split their columns (``ff``), ``wo`` and ``cm_v`` their rows, so a rank
holds h/M heads of the time mix and of its state ``S``; the token-shift
mix and its LoRA, the decay LoRA and the per-channel ``w0``, ``u`` and
``ln_scale`` stay replicated and run whole on every rank. The mixed
inputs pass ``to_model`` into the split projections; ``w0`` plus the
decay LoRA's output, ``u`` and ``ln_scale`` pass ``layers.channels`` (the
rank's channels, the gradient summed over the model axis). ``wo``'s
product is summed over the model axis (``act_from_model``). The channel
mix's receptance ``sigmoid(x_r cm_r)`` holds the rank's columns, but it
multiplies the *sum* of the ranks' ``cm_v`` products: that sum is
reduce-scattered onto the rank's columns, multiplied there and the
product gathered whole — never a per-rank partial summed afterwards. On a
sequence shard both mixes gather the sequence first (``whole_seq``: the
token shift reads the previous position) and hand back the rank's rows
(``act_from_model``'s reduce-scatter, ``own_rows``). ``x_prev`` and the
channel mix's state stay whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RWKVCfg
from repro_torch.distributed import collectives as coll
from repro_torch.models.layers import act_from_model, channels, dense_init, \
    from_model, model_group, own_rows, param, to_model, whole_seq

_MIX = ("w", "k", "v", "r", "g")
CHUNK = 32


class RWKV(nn.Module):
    """RWKV-6 weights (the reference's ``rwkv_init``) in its layout: the
    token-shift mix ``mix_base`` (5, d) with its LoRA ``mix_a`` (d, 5·L)
    and ``mix_b`` (5, L, d); ``wr``/``wk``/``wv``/``wg``/``wo`` (d, d); the
    decay ``w0`` (d,) with its LoRA ``w_a``/``w_b``; the bonus ``u`` and the
    group norm's ``ln_scale`` (d,); the channel mix's ``cm_mix`` (2, d),
    ``cm_k`` (d, d_ff), ``cm_v`` (d_ff, d) and ``cm_r`` (d, d)."""

    def __init__(self, cfg: RWKVCfg, d: int, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        if cfg.n_heads * cfg.head_dim != d:
            raise ValueError(f"rwkv heads {cfg.n_heads} x {cfg.head_dim} != "
                             f"d_model {d}")
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        zeros = dict(device=device, dtype=dtype)
        m = len(_MIX)
        param(self, "mix_base", torch.zeros((m, d), **zeros),
              ("stub", "embed_norm"))
        param(self, "mix_a", dense_init((d, m * cfg.mix_lora), **kw),
              ("embed", "lora"))
        param(self, "mix_b", dense_init((m, cfg.mix_lora, d), **kw),
              ("stub", "lora", "embed"))
        for name in ("wr", "wk", "wv", "wg"):
            param(self, name, dense_init((d, d), **kw), ("embed", "ff"))
        param(self, "w0", torch.linspace(-6.0, -0.5, d, device=device)
              .to(dtype), ("embed_norm",))
        param(self, "w_a", dense_init((d, cfg.decay_lora), **kw),
              ("embed", "lora"))
        param(self, "w_b", dense_init((cfg.decay_lora, d), scale=0.01, **kw),
              ("lora", "embed"))
        param(self, "u", torch.zeros(d, **zeros), ("embed_norm",))
        param(self, "ln_scale", torch.zeros(d, **zeros), ("embed_norm",))
        param(self, "wo", dense_init((d, d), **kw), ("ff", "embed"))
        param(self, "cm_mix", torch.zeros((2, d), **zeros),
              ("stub", "embed_norm"))
        param(self, "cm_k", dense_init((d, cfg.d_ff), **kw), ("embed", "ff"))
        param(self, "cm_v", dense_init((cfg.d_ff, d), **kw), ("ff", "embed"))
        param(self, "cm_r", dense_init((d, d), **kw), ("embed", "ff"))


def _token_shift(x, x_prev):
    """x: (B, S, d). x shifted right by one (x_prev fills position 0)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mixed_inputs(p: RWKV, x, xs):
    """Data-dependent lerp between x and shifted x for each of w, k, v, r,
    g."""
    base = torch.sigmoid(p.mix_base)                            # (5, d)
    dx = xs - x
    lo = torch.tanh(torch.matmul(x + 0.5 * dx, p.mix_a))
    lo = lo.reshape(*lo.shape[:-1], len(_MIX), -1)
    dyn = torch.einsum("bsml,mld->bsmd", lo, p.mix_b)
    mix = torch.clamp(base + dyn, 0.0, 1.0)                    # (B,S,5,d)
    return tuple(x + dx * mix[..., i, :] for i in range(len(_MIX)))


def _head_split(x, h):
    return x.reshape(*x.shape[:-1], h, -1)


def _group_norm(p: RWKV, y):
    """Per-head LayerNorm of the wkv output, y (..., h, dh) in the model
    dtype: mean and variance in float32, rounded to y's dtype, as the
    reference's ``jnp.mean`` / ``jnp.var`` give them."""
    dt = y.dtype
    yf = y.float()
    mu = yf.mean(-1, keepdim=True).to(dt)
    var = yf.var(-1, unbiased=False, keepdim=True).to(dt)
    yn = (y - mu) * torch.rsqrt(var + 1e-5)
    flat = yn.reshape(*y.shape[:-2], -1)
    return flat * (1.0 + channels(p.ln_scale, flat.shape[-1]))


def _heads(p: RWKV) -> int:
    """The time mix's heads on this rank: all of them, or a model rank's
    share (``wr``'s columns)."""
    return p.wr.shape[1] // p.cfg.head_dim


def _decay_log(p: RWKV, xw, h):
    """Per-channel log decay (<= 0) in float32 of the rank's ``h`` heads:
    the exp runs in the model dtype before the cast, as in the
    reference."""
    lora = torch.matmul(torch.tanh(torch.matmul(xw, p.w_a)), p.w_b)
    w = channels(p.w0 + lora, p.wr.shape[1])
    return _head_split(-torch.exp(torch.clamp(w, -12.0, 2.0)).float(), h)


def wkv_chunked(r, k, v, wlog, u, *, chunk: int = CHUNK):
    """Chunked linear attention with per-channel decay.

    r, k, v, wlog: (B, S, h, dh) float32 (wlog <= 0); u (h, dh). Returns y
    (B, S, h, dh) and the final state (B, h, dh, dh)."""
    b, s, h, dh = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v, wlog = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, wlog))
    n = (s + pad) // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    S = torch.zeros((b, h, dh, dh), dtype=r.dtype, device=r.device)
    ys = []
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        rb, kb, vb, wb = r[:, sl], k[:, sl], v[:, sl], wlog[:, sl]
        cw = torch.cumsum(wb, dim=1)        # inclusive cumulative log decay
        cw_prev = cw - wb                   # cumlog up to t-1
        # inter-chunk: y += (r_t * exp(cw_prev_t)) . S
        r_in = rb * torch.exp(cw_prev)
        y = torch.einsum("bthj,bhji->bthi", r_in, S)
        # intra-chunk: pairwise decay exp(cw_prev[t] - cw[s]) for s < t
        dec = torch.exp(torch.clamp(cw_prev[:, :, None] - cw[:, None],
                                    -60.0, 0.0))
        sc = torch.einsum("bthj,bshj,btshj->bhts", rb, kb, dec)
        sc = torch.where(tri[None, None], sc, torch.zeros_like(sc))
        # current-token bonus
        diag = torch.einsum("bthj,bthj->bth", rb * u, kb)
        y = y + torch.einsum("bhts,bshi->bthi", sc, vb)
        y = y + diag[..., None] * vb
        # S' = exp(cw_end) * S + sum_s exp(cw_end - cw_s) k_s v_s^T
        cw_end = cw[:, -1]                                      # (b,h,dh)
        dk = torch.exp(cw_end[:, None] - cw)
        S = torch.exp(cw_end)[..., None] * S + torch.einsum(
            "bshj,bshi->bhji", kb * dk, vb)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], S


def _project(p: RWKV, xs, w, h=None):
    """A mixed input into a split projection (``to_model``), split by
    head when ``h`` is given."""
    y = torch.matmul(to_model(xs), w)
    return y if h is None else _head_split(y, h)


def rwkv_time_mix(p: RWKV, x, *, x_prev=None):
    """Full-sequence time mixing, x (B, S, d) (a sequence shard's rows
    under ``layers.sequence_parallel``). Returns (y, (x[:, -1], S)): the
    decode state after the last position, ``S`` of the rank's heads."""
    x = whole_seq(x)
    b, s, d = x.shape
    h = _heads(p)
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xw, xk, xv, xr, xg = _mixed_inputs(p, x, _token_shift(x, x_prev))
    r = _project(p, xr, p.wr, h).float()
    k = _project(p, xk, p.wk, h).float()
    v = _project(p, xv, p.wv, h).float()
    g = _project(p, xg, p.wg)
    wlog = _decay_log(p, xw, h)
    u = _head_split(channels(p.u, p.wr.shape[1]).float(), h)
    y, S = wkv_chunked(r, k, v, wlog, u)
    y = _group_norm(p, y.to(x.dtype)) * F.silu(g)
    return act_from_model(torch.matmul(y, p.wo)), (x[:, -1].clone(), S)


def rwkv_time_mix_decode(p: RWKV, x, state: dict, *, commit=None):
    """One token per slot, x (B, d) -> y (B, d). ``state`` is
    ``{"x_prev": (B, d), "S": (B, h, dh, dh) float32}`` (a model rank's
    h/M heads), updated in place (only the ``commit`` rows when
    given)."""
    h = _heads(p)
    xw, xk, xv, xr, xg = (t[:, 0] for t in _mixed_inputs(
        p, x[:, None], state["x_prev"][:, None]))
    r = _project(p, xr, p.wr, h).float()
    k = _project(p, xk, p.wk, h).float()
    v = _project(p, xv, p.wv, h).float()
    g = _project(p, xg, p.wg)
    wlog = _decay_log(p, xw, h)
    u = _head_split(channels(p.u, p.wr.shape[1]).float(), h)
    S = state["S"]
    y = (torch.einsum("bhj,bhji->bhi", r, S)
         + torch.einsum("bhj,bhj,bhi->bhi", r, u * k, v))
    S_new = torch.exp(wlog)[..., None] * S + k[..., :, None] * v[..., None, :]
    y = _group_norm(p, y.to(x.dtype)[:, None])[:, 0] * F.silu(g)
    x_prev = x
    if commit is not None:
        S_new = torch.where(commit[:, None, None, None], S_new, S)
        x_prev = torch.where(commit[:, None], x, state["x_prev"])
    state["S"].copy_(S_new)
    state["x_prev"].copy_(x_prev)
    return from_model(torch.matmul(y, p.wo))


def _receptance_times(p: RWKV, xk, xr):
    """``sigmoid(x_r cm_r) * (relu(x_k cm_k)^2 cm_v)``. On more than one
    model rank ``cm_v``'s product is the rank's partial sum and the
    receptance the rank's columns: the sum is reduce-scattered onto those
    columns, multiplied there, and the product gathered whole (every
    rank's gradient of it alike)."""
    k = torch.square(F.relu(_project(p, xk, p.cm_k)))
    kv = torch.matmul(k, p.cm_v)
    r = torch.sigmoid(_project(p, xr, p.cm_r))
    if r.shape[-1] == kv.shape[-1]:
        return r * from_model(kv)
    group = model_group()
    kv = coll.scatter_seq_from_model(kv, -1, group)
    return coll.gather_seq(r * kv, -1, group)


def rwkv_channel_mix(p: RWKV, x, *, x_prev=None):
    """x (B, S, d) (a sequence shard's rows under
    ``layers.sequence_parallel``). Returns (y, x[:, -1])."""
    x = whole_seq(x)
    b, _, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_prev)
    mix = torch.sigmoid(p.cm_mix)
    xk = x + (xs - x) * mix[0]
    xr = x + (xs - x) * mix[1]
    return own_rows(_receptance_times(p, xk, xr)), x[:, -1].clone()


def rwkv_channel_mix_decode(p: RWKV, x, x_prev, *, commit=None):
    """One token per slot; ``x_prev`` (B, d) is updated in place (only the
    ``commit`` rows when given). Returns y (B, d)."""
    xk = x + (x_prev - x) * torch.sigmoid(p.cm_mix[0])
    xr = x + (x_prev - x) * torch.sigmoid(p.cm_mix[1])
    y = _receptance_times(p, xk, xr)
    x_prev.copy_(x if commit is None
                 else torch.where(commit[:, None], x, x_prev))
    return y


def rwkv_init_state(cfg: RWKVCfg, d: int, batch: int, dtype=torch.bfloat16,
                    device=None) -> dict:
    """The reference's ``rwkv_init_state`` (keys ``x_prev_tm``, ``S``,
    ``x_prev_cm``)."""
    return {
        "x_prev_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "S": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                         dtype=torch.float32, device=device),
        "x_prev_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def init_decode_cache(cfg: RWKVCfg, d: int, batch: int, dtype,
                      device) -> dict:
    """A layer's decode cache, laid out as the reference's decode state
    lays it out: ``{"rwkv_tm": {"x_prev", "S"}, "rwkv_cm": x_prev}`` (every
    head: the unsharded state)."""
    return {"rwkv_tm": {"x_prev": torch.zeros((batch, d), dtype=dtype,
                                              device=device),
                        "S": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                                          cfg.head_dim),
                                         dtype=torch.float32, device=device)},
            "rwkv_cm": torch.zeros((batch, d), dtype=dtype, device=device)}
