"""Shape/sharding specs for every (arch x input-shape) cell (port of
``repro.launch.specs``).

Nothing here allocates: ``abstract_params`` builds the model under
``FakeTensorMode`` (shapes and dtypes only, as ``launch.plan`` does), the
batch and optimizer stand-ins are ``meta`` tensors, and
``abstract_decode_state`` runs ``init_decode_state`` on fake params. A
tree is a flat ``{name: tensor}`` dict and its specs a ``{name: spec}``
dict with the same names (``distributed.sharding``'s tuples).
``decode_state_specs`` assigns specs to serving caches by leaf name (KV
caches shard batch over DP and *sequence over the model axis*).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import SHAPES, ModelCfg
from repro_torch.distributed.sharding import (ShardingRules, axes_size,
                                              make_specs, param_axes)


def _fake_model(cfg: ModelCfg, dtype):
    from repro_torch.models import transformer as T
    return T.init(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu", dtype=dtype)


def abstract_params(cfg: ModelCfg) -> tuple:
    """({name: fake float32 master}, {name: logical axes}) of the model,
    nothing allocated (one build a config, cached; each call gets its own
    dicts)."""
    shapes, axes = _abstract_params(cfg)
    return dict(shapes), dict(axes)


@functools.lru_cache(maxsize=None)
def _abstract_params(cfg: ModelCfg) -> tuple:
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        model = _fake_model(cfg, torch.float32)
        shapes = dict(model.named_parameters())
    return shapes, param_axes(model)


def param_specs(cfg: ModelCfg, rules: ShardingRules, mesh,
                notes: list | None = None) -> tuple:
    """(param shapes, {name: spec})."""
    shapes, axes = abstract_params(cfg)
    return shapes, make_specs(axes, {k: v.shape for k, v in shapes.items()},
                              rules, mesh, notes)


def abstract_opt(param_shapes: dict) -> dict:
    """The AdamW state of ``adamw_init`` as meta tensors, flat: ``mu.<name>``
    and ``nu.<name>`` float32 like each parameter, and the int32 ``count``."""
    out = {}
    for t in ("mu", "nu"):
        out.update({f"{t}.{k}": torch.empty(v.shape, dtype=torch.float32,
                                            device="meta")
                    for k, v in param_shapes.items()})
    out["count"] = torch.empty((), dtype=torch.int32, device="meta")
    return out


def opt_specs(p_specs: dict) -> dict:
    """AdamW moments shard exactly like their parameters; ``count`` is
    replicated."""
    out = {}
    for t in ("mu", "nu"):
        out.update({f"{t}.{k}": s for k, s in p_specs.items()})
    out["count"] = ()
    return out


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelCfg, shape_name: str, rules: ShardingRules,
                mesh) -> tuple:
    """(shapes, specs) for a train/prefill batch: rows over the data axes
    where they divide (``dp_ok``), else replicated."""
    info = SHAPES[shape_name]
    b, s = info["global_batch"], info["seq_len"]
    dp = tuple(rules.data_axes)
    dp_ok = b % axes_size(mesh, dp) == 0
    rows = (dp[0] if len(dp) == 1 else dp) if dp_ok else None

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    shapes, specs = {}, {}
    s_text = s
    if cfg.frontend == "patch_stub":
        s_text = s - cfg.frontend_len
        shapes["patch_embeds"] = meta((b, cfg.frontend_len, cfg.d_model),
                                      torch.bfloat16)
        specs["patch_embeds"] = (rows, None, None)
    if cfg.encoder is not None:
        shapes["encoder_frames"] = meta(
            (b, cfg.encoder.n_frames, cfg.encoder.d_model), torch.bfloat16)
        specs["encoder_frames"] = (rows, None, None)
    shapes["tokens"] = meta((b, s_text), torch.int32)
    specs["tokens"] = (rows, None)
    if info["kind"] == "train":
        shapes["targets"] = meta((b, s_text), torch.int32)
        specs["targets"] = (rows, None)
    return shapes, specs


# ---------------------------------------------------------------------------
# Decode-state specs
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    "k": ("batch", "seq_cache", "kv_heads_cache", None),
    "v": ("batch", "seq_cache", "kv_heads_cache", None),
    "latent": ("batch", "seq_cache", None),
    "rope": ("batch", "seq_cache", None),
    "pos": ("batch", "seq_cache"),
    "S": ("batch", "heads", None, None),
    "h": ("batch", "ff"),
    "conv": ("batch", None, "ff"),
    "x_prev": ("batch", None),
    "rwkv_cm": ("batch", None),
    "conv_buf": ("batch", None, None),
    "queue": ("batch", None, None),
    "t": (),
}


def flatten(tree, prefix: str = "") -> dict:
    """``{dotted path: tensor}`` of a nest of dicts and lists (None leaves
    dropped)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _leaf_key(label: str) -> str:
    """The last name of a dotted path that is not a list index."""
    for part in reversed(label.split(".")):
        if not part.isdigit():
            return part
    return ""


def decode_state_specs(state: dict, rules: ShardingRules, mesh, *,
                       seq_cache_axis="model") -> dict:
    """Specs of a decode state's leaves (``flatten``'s names), by the leaf
    names it shares with the reference's state. The KV sequence dim shards
    over the model axis (distributed decode attention); recurrent states
    shard over heads/width; everything falls back to replication on
    indivisibility. The port holds one cache a layer, so no stacked layer
    axis leads a leaf; leaves the reference has no name for (the cross
    read's positions) are replicated."""
    table = rules.table()
    table.update({"seq_cache": seq_cache_axis,
                  "kv_heads_cache": None})   # seq takes the model axis

    def pick(label, leaf):
        base = _CACHE_AXES.get(_leaf_key(label))
        if base is None or leaf.dim() != len(base):
            return (None,) * leaf.dim()
        entries, used = [], set()
        for name, dim in zip(base, leaf.shape):
            ax = table.get(name)
            ax_t = ax if isinstance(ax, tuple) else (ax,) if ax else ()
            size = axes_size(mesh, ax_t) if ax_t else 1
            if not ax_t or dim % size != 0 or any(a in used for a in ax_t):
                entries.append(None)
            else:
                entries.append(ax_t[0] if len(ax_t) == 1 else ax_t)
                used.update(ax_t)
        return tuple(entries)

    return {label: pick(label, leaf) for label, leaf in flatten(state).items()}


def abstract_decode_state(cfg: ModelCfg, shape_name: str) -> tuple:
    """(flat decode state of fake tensors, (batch, seq)) for a serving cell:
    ``init_decode_state`` on fake params in the compute dtype, with a zero
    encoder output for an encoder-decoder config."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    info = SHAPES[shape_name]
    b, s = info["global_batch"], info["seq_len"]
    dt = T._dtype(cfg)
    with FakeTensorMode():
        params = _fake_model(cfg, dt)
        enc_out = None
        if cfg.encoder is not None:
            enc_out = torch.zeros((b, cfg.encoder.n_frames, cfg.d_model),
                                  dtype=dt)
        state = D.init_decode_state(params, cfg, b, max_len=s,
                                    enc_out=enc_out)
    return flatten(state), (b, s)
