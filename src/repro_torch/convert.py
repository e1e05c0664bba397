"""Weight bridge: the reference's parameter tree -> the port's model.

``from_jax_params(params, cfg, device=..., dtype=...)`` takes the tree that
``repro.models.transformer.init`` builds, with its axis annotations split
off and its leaves as numpy arrays (anything ``np.asarray`` accepts), and
returns a ``repro_torch.models.transformer.Transformer`` holding the same
numbers. Scanned segments carry a leading layer axis; it is unstacked into
one ``Block`` per layer; unscanned segments are lists of layer trees
already. Einsum layouts are kept as they are: ``wq (d, H, dh)``, ``wo (H,
dh, d)``, MLA's ``wdq``/``wuq``/``wdkv``/``wuk``/``wuv``, the MoE's
``router (d, E)``, ``up/gate (E, d, f)``, ``down (E, f, d)`` and shared
experts, the RG-LRU's ``wa``/``wb``/``conv``/``conv_b``/``wr``/``wi``/
``br``/``bi``/``lam``/``wo`` (a scanned (rec, rec, attn) pattern keeps
them under ``sub0``..``sub2``), the RWKV-6 block's ``rwkv`` leaves
(``mix_base``, ``mix_a``, ``mix_b``, ``wr``/``wk``/``wv``/``wg``/``wo``,
``w0``, ``w_a``, ``w_b``, ``u``, ``ln_scale``, ``cm_*``), a decoder
block's cross attention ``cross`` behind ``lnx``, ``lm_head (d, vocab)``,
the learned ``pos_embed (L, d)``, the whisper ``encoder`` (its segments,
``final_norm`` and ``proj``), ``soi.compress (stride, d, d)``, ``soi.fuse
(2d, d)``. A block or final norm leaf ``{"scale": ...}`` becomes its scale
tensor, and a LayerNorm's ``bias`` beside it becomes ``<name>_bias``
(``ln1_bias``, ``ln2_bias``, ``lnx_bias``, ``final_norm_bias``); the plain
MLP kinds (relu2, gelu) carry no ``gate``. A leaf missing or left over on
either side is refused. This module imports no JAX: the caller hands over
numpy.

``from_jax_ghostnet`` does the same for ``repro.models.ghostnet.init``'s
tree (``blocks`` of ``primary``/``cheap`` convs, ``head``, ``skip_proj``
keyed by pair position).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.models.ghostnet import GhostNet, GhostNetConfig
from repro_torch.models.transformer import Transformer
from repro_torch.models.unet import UNet, UNetConfig


def _layer_trees(params: dict, cfg, index) -> list:
    """Per-layer block trees, in layer order (``cfg`` a ModelCfg or an
    EncoderCfg: anything with ``segments``)."""
    out = []
    for seg_p, seg in zip(params["segments"], cfg.segments):
        if not seg.scan:
            out.extend(seg_p)
            continue
        for g in range(seg.n_groups):
            for i in range(len(seg.blocks)):
                sub = seg_p[f"sub{i}"]
                out.append(_index_tree(sub, g, index))
    return out


def _index_tree(tree, i, index):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i, index) for k, v in tree.items()}
    return index(tree, i)


def _index_layer(x, i):
    return np.asarray(x)[i]


@torch.no_grad()
def from_jax_params(params: dict, cfg: ModelCfg, *, device=None,
                    dtype=torch.float32) -> Transformer:
    """Build the port's model from the reference's parameter values."""
    dev = resolve_device(device)
    model = Transformer(cfg, generator=torch.Generator(device="cpu"),
                        device="meta", dtype=dtype)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    _load_checked(model, {k: t(v) for k, v in
                          reference_names(params, cfg).items()})
    return model


def reference_names(params: dict, cfg: ModelCfg, *,
                    index=_index_layer) -> dict:
    """``{the port's parameter name: leaf}`` of a tree laid out as the
    reference's parameter tree — its values, or any tree of the same
    structure (its logical axes, its specs). ``index(leaf, g)`` takes layer
    group ``g`` of a scanned segment's stacked leaf (by default numpy
    indexing; for the axes tree, ``leaf[1:]`` drops the ``"layers"``
    axis)."""

    def norm(name, leaf):
        # a block or final norm: its scale, and a LayerNorm's bias
        out = {name: leaf["scale"]}
        if "bias" in leaf:
            out[name + "_bias"] = leaf["bias"]
        return out

    def blocks(prefix, layers, n_layers):
        if len(layers) != n_layers:
            raise ValueError(f"{len(layers)} {prefix}layers in the tree, "
                             f"{n_layers} in the config")
        for i, lp in enumerate(layers):
            pre = f"{prefix}{i}."
            for nm in ("ln1", "ln2", "lnx"):
                if nm in lp:
                    tensors.update(norm(pre + nm, lp[nm]))
            for mod in ("attn", "cross", "rglru", "rwkv", "mlp", "moe"):
                for name, leaf in lp.get(mod, {}).items():
                    if isinstance(leaf, dict):       # a norm: its scale
                        leaf = leaf["scale"]
                    tensors[f"{pre}{mod}.{name}"] = leaf

    tensors = {"embed": params["embed"],
               **norm("final_norm", params["final_norm"])}
    blocks("blocks.", _layer_trees(params, cfg, index), cfg.n_layers)
    if cfg.encoder is not None:
        enc = params["encoder"]
        blocks("encoder.blocks.", _layer_trees(enc, cfg.encoder, index),
               sum(s.n_layers for s in cfg.encoder.segments))
        tensors.update(norm("encoder.final_norm", enc["final_norm"]))
        if "proj" in enc:
            tensors["encoder.proj"] = enc["proj"]
    if cfg.learned_pos_len:
        tensors["pos_embed"] = params["pos_embed"]
    if not cfg.tie_embeddings:
        tensors["lm_head"] = params["lm_head"]
    if cfg.soi is not None:
        tensors["soi_compress"] = params["soi"]["compress"]
        tensors["soi_fuse"] = params["soi"]["fuse"]
    return tensors


def _load_checked(model: torch.nn.Module, tensors: dict) -> None:
    """Load ``tensors`` into ``model`` after checking that the names and
    shapes are exactly the model's."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tensors.items()}
    if want != got:
        bad = [k for k in want if k in got and want[k] != got[k]]
        raise ValueError(f"parameter mismatch: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}, shapes {bad}")
    model.load_state_dict(tensors, assign=True)


@torch.no_grad()
def from_jax_unet(params: dict, nstate: dict, cfg: UNetConfig, *,
                  device=None, dtype=torch.float32) -> UNet:
    """Build the port's U-Net from the reference's parameter and norm-state
    values."""
    dev = resolve_device(device)
    model = UNet(cfg, generator=torch.Generator(device="cpu"),
                 device="meta", dtype=dtype)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    tensors = {}
    for side in ("enc", "dec"):
        if len(params[side]) != len(nstate[side]):
            raise ValueError(f"{len(params[side])} {side} layers, "
                             f"{len(nstate[side])} norm states")
        for i, (lp, ns) in enumerate(zip(params[side], nstate[side])):
            pre = f"{side}.{i}."
            tensors[pre + "w"] = t(lp["conv"]["w"])
            tensors[pre + "b"] = t(lp["conv"]["b"])
            tensors[pre + "scale"] = t(lp["norm"]["scale"])
            tensors[pre + "bias"] = t(lp["norm"]["bias"])
            tensors[pre + "mean"] = t(ns["mean"])
            tensors[pre + "var"] = t(ns["var"])
    tensors["proj.w"] = t(params["proj"]["w"])
    tensors["proj.b"] = t(params["proj"]["b"])
    for p, up in params.get("up", {}).items():
        tensors[f"up.{int(p)}.w"] = t(up["w"])
        tensors[f"up.{int(p)}.b"] = t(up["b"])
    _load_checked(model, tensors)
    return model


@torch.no_grad()
def from_jax_ghostnet(params: dict, cfg: GhostNetConfig, *, device=None,
                      dtype=torch.float32) -> GhostNet:
    """Build the port's GhostNet from the reference's parameter values."""
    dev = resolve_device(device)
    model = GhostNet(cfg, generator=torch.Generator(device="cpu"),
                     device="meta", dtype=dtype)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    tensors = {}
    for i, bp in enumerate(params["blocks"]):
        for conv in ("primary", "cheap"):
            for leaf in ("w", "b"):
                tensors[f"blocks.{i}.{conv}.{leaf}"] = t(bp[conv][leaf])
    for leaf in ("w", "b"):
        tensors[f"head.{leaf}"] = t(params["head"][leaf])
        for p, sp in params.get("skip_proj", {}).items():
            tensors[f"skip_proj.{int(p)}.{leaf}"] = t(sp[leaf])
    _load_checked(model, tensors)
    return model
