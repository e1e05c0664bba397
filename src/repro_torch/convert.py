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
them under ``sub0``..``sub2``), ``lm_head (d, vocab)``, ``soi.compress
(stride, d, d)``, ``soi.fuse (2d, d)``. A norm leaf ``{"scale": ...}``
becomes its scale tensor. This module imports no JAX: the caller hands
over numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.models.transformer import Transformer


def _layer_trees(params: dict, cfg: ModelCfg) -> list:
    """Per-layer block trees, in layer order."""
    out = []
    for seg_p, seg in zip(params["segments"], cfg.segments):
        if not seg.scan:
            out.extend(seg_p)
            continue
        for g in range(seg.n_groups):
            for i in range(len(seg.blocks)):
                sub = seg_p[f"sub{i}"]
                out.append(_index_tree(sub, g))
    return out


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


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

    tensors = {"embed": t(params["embed"]),
               "final_norm": t(params["final_norm"]["scale"])}
    layers = _layer_trees(params, cfg)
    if len(layers) != len(model.blocks):
        raise ValueError(f"{len(layers)} layers in the tree, "
                         f"{len(model.blocks)} in the config")
    for i, lp in enumerate(layers):
        pre = f"blocks.{i}."
        tensors[pre + "ln1"] = t(lp["ln1"]["scale"])
        tensors[pre + "ln2"] = t(lp["ln2"]["scale"])
        for mod in ("attn", "rglru", "mlp", "moe"):
            for name, leaf in lp.get(mod, {}).items():
                if isinstance(leaf, dict):           # a norm: its scale
                    leaf = leaf["scale"]
                tensors[f"{pre}{mod}.{name}"] = t(leaf)
    if not cfg.tie_embeddings:
        tensors["lm_head"] = t(params["lm_head"])
    if cfg.soi is not None:
        tensors["soi_compress"] = t(params["soi"]["compress"])
        tensors["soi_fuse"] = t(params["soi"]["fuse"])
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tensors.items()}
    if want != got:
        bad = [k for k in want if k in got and want[k] != got[k]]
        raise ValueError(f"parameter mismatch: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}, shapes {bad}")
    model.load_state_dict(tensors, assign=True)
    return model
