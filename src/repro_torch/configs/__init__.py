"""Architecture config registry of the port: ``get(arch_id)`` /
``get_smoke(arch_id)``. Only the architectures whose layers the port runs
are registered: the LMs in ``ARCHS`` (what ``launch/serve.py`` takes) and
the paper's conv nets in ``CONV_ARCHS`` (the streaming U-Net and the
offline GhostNet), whose ``soi`` is a ``core.soi.SOIConvCfg``. Every
architecture of the reference's registry has its counterpart here."""

from __future__ import annotations

import importlib

ARCHS = ("qwen3-1.7b", "deepseek-v2-236b", "recurrentgemma-9b",
         "olmoe-1b-7b", "h2o-danube-1.8b", "nemotron-4-15b",
         "mistral-large-123b", "rwkv6-1.6b", "paligemma-3b", "whisper-tiny")
CONV_ARCHS = ("soi-unet-dns", "soi-ghostnet-asc")

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCHS + CONV_ARCHS}


def module(arch: str):
    """The config module of an architecture id (``config`` /
    ``smoke_config``)."""
    if arch not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch])


def get(arch: str, soi=None, n_layers: int | None = None):
    """Full-size config of an architecture id; ``n_layers`` cuts an LM's
    depth (every width stays)."""
    if n_layers is None:
        return module(arch).config(soi=soi)
    if arch in CONV_ARCHS:
        raise ValueError(f"{arch} has a fixed depth; n_layers is for LMs")
    return module(arch).config(soi=soi, n_layers=n_layers)


def get_smoke(arch: str, soi=None):
    """Reduced same-family config for CPU tests."""
    return module(arch).smoke_config(soi=soi)
