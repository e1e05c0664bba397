"""Analysis targets: the engine configurations whose hot paths are under
contract, plus the scripted traffic used by the runtime passes (port of
``repro.analysis.targets``).

The matrix mirrors the reference's: dense/paged layouts x GQA (qwen3
smoke) / MLA absorbed decode (deepseek-v2 smoke) x speculative windows
on/off, plus a prefix-cache target exercising the hydrate/COW/scrub
entries and a telemetry target, all on the port's smoke configs in f32.
Every engine is smoke-scale — the contracts under analysis (in-place
state, graph keys, dtype flow, FLOPs a step against the middle's floor)
are scale-independent.

Targets are built lazily (``build_target``) on ``device`` (the card by
default; the tests pass ``"cpu"``): each constructs a dedicated
``SOIEngine`` — the analyzer drives real traffic through it, and paged
engines tolerate exactly one live decode state. On the card only the GQA
cells run (``CARD_TARGETS``, the card's ``default_targets``): the MLA smoke
config's head dims (flash at dqk 24 / dv 16, a latent of 24) are no
instantiation of the flash and MLA kernels, so ``build_target`` refuses an
MLA cell on the card up front; the MLA path's kernels run at full width in
``chip_smoke.py``'s deepseek-v2 phases.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


def _gqa_cfg(soi="pp"):
    import repro_torch.configs.qwen3_1_7b as Q
    return dataclasses.replace(Q.smoke_config(soi=soi), dtype="float32")


def _mla_cfg(soi="pp"):
    import repro_torch.configs.deepseek_v2_236b as DS
    return dataclasses.replace(DS.smoke_config(soi=soi), dtype="float32")


# name -> (cfg builder, engine kwargs)
_COMMON = dict(max_concurrent_decodes=2, max_len=32)
MATRIX = {
    "gqa-dense": (_gqa_cfg, dict(_COMMON)),
    "gqa-paged": (_gqa_cfg, dict(_COMMON, paged=True, page_size=8)),
    "gqa-dense-spec": (_gqa_cfg, dict(_COMMON, speculate=2)),
    "gqa-paged-spec": (_gqa_cfg, dict(_COMMON, paged=True, page_size=8,
                                      speculate=2)),
    "mla-dense": (_mla_cfg, dict(_COMMON)),
    "mla-paged": (_mla_cfg, dict(_COMMON, paged=True, page_size=8)),
    "mla-dense-spec": (_mla_cfg, dict(_COMMON, speculate=2)),
    "mla-paged-spec": (_mla_cfg, dict(_COMMON, paged=True, page_size=8,
                                      speculate=2)),
    # hydrate / COW / scrub entries only exist on a prefix-cache engine;
    # max_len grows so an aligned prefix boundary (lcm 32) is reachable
    "gqa-paged-pc": (_gqa_cfg, dict(max_concurrent_decodes=2, max_len=96,
                                    paged=True, page_size=16,
                                    prefill_chunk=16, prefix_cache=True)),
    # telemetry-on serving: the per-step metrics vector must ride the
    # existing deferred drain without new host syncs or rebound state
    "gqa-paged-tele": (_gqa_cfg, dict(_COMMON, paged=True, page_size=8,
                                      telemetry=True)),
}


@dataclasses.dataclass
class AnalysisTarget:
    name: str
    cfg: Any
    engine: Any
    params: Any
    prompt_lengths: Tuple[int, ...]


def _on_card(device) -> bool:
    return torch.device("cuda" if device is None else device).type == "cuda"


def check_device(name: str, device=None) -> None:
    """Raise ``NotImplementedError`` if ``name`` cannot run on ``device``
    (None: the card): a cell outside ``CARD_TARGETS`` reaches kernels that
    have no instantiation at its smoke widths there."""
    if name not in MATRIX:
        raise KeyError(f"unknown analysis target {name!r} (have "
                       f"{', '.join(MATRIX)})")
    if not _on_card(device) or name in CARD_TARGETS:
        return
    from repro_torch.kernels import decode_attention, flash_attention
    a = MATRIX[name][0]().segments[0].blocks[0].attn
    raise NotImplementedError(
        f"analysis target {name!r} does not run on the card: its smoke "
        f"config has no kernel instantiation there (flash_attention at "
        f"(dqk, dv) = ({a.qk_nope + a.qk_rope}, {a.v_head}), not in "
        f"{flash_attention.HEAD_DIMS}; the MLA decode reads at (L, R) = "
        f"({a.kv_lora}, {a.qk_rope}), not in {decode_attention.MLA_DIMS}); "
        f"run it with device='cpu', or take one of {CARD_TARGETS}")


def build_target(name: str, device=None) -> AnalysisTarget:
    from repro_torch import resolve_device
    from repro_torch.engine.soi_engine import SOIEngine
    from repro_torch.models import transformer as T

    check_device(name, device)
    dev = resolve_device(device)
    cfg_fn, kwargs = MATRIX[name]
    cfg = cfg_fn()
    params = T.init(cfg, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    engine = SOIEngine(cfg, device=dev, **kwargs)
    if name.endswith("-pc"):
        # two prompts sharing a 40-token head: the second hits at the
        # 32-aligned boundary, exercising hydrate + shared-page insert
        lengths = (40, 40)
    else:
        # spans two pow2 buckets (16 and 32) and both SOI phases
        lengths = (5, 9, 17)
    return AnalysisTarget(name=name, cfg=cfg, engine=engine, params=params,
                          prompt_lengths=lengths)


def default_targets(device=None) -> list:
    """The cells that run on ``device`` (None: the card): the whole matrix
    on the CPU, ``CARD_TARGETS`` on the card."""
    return list(CARD_TARGETS) if _on_card(device) else list(MATRIX)


# the cells whose kernels have an instantiation at the smoke widths
CARD_TARGETS = tuple(n for n in MATRIX if n.startswith("gqa"))


def prompts(target: AnalysisTarget, seed: int = 7) -> list:
    """The scripted prompts (int64 token ids on the engine's device):
    prefix-cache targets share one head so the second prompt hits."""
    g = torch.Generator().manual_seed(seed)
    lengths = target.prompt_lengths
    vocab = target.cfg.vocab
    head = torch.randint(0, vocab, (max(lengths),), generator=g)
    out = []
    for length in lengths:
        toks = torch.randint(0, vocab, (length,), generator=g)
        if target.name.endswith("-pc"):
            toks = head[:length]
        out.append(toks.to(target.engine.device))
    return out


def drive_traffic(target: AnalysisTarget, *, gen_steps: int = 3,
                  drain=None, fresh: bool = True):
    """Scripted 'normal traffic': staggered prefills + inserts, a few
    generate steps, a free / re-insert cycle, another step. ``drain`` (if
    given) is called with each step's ResultTokens AFTER the next step has
    been dispatched — the serving loop's deferred-drain idiom. ``fresh``
    starts from ``init_decode_state``; ``fresh=False`` repeats the traffic
    on the live state (every occupied slot freed first), so the graphs
    captured before stay. Returns the final decode state (also the
    engine's live one)."""
    engine, params = target.engine, target.params
    slots = engine.max_concurrent_decodes
    if fresh:
        ds = engine.init_decode_state(params)
    else:
        ds = engine._live
        for slot in np.nonzero(engine._occupied)[0]:
            ds = engine.free_slot(ds, int(slot))
    for i, toks in enumerate(prompts(target)):
        slot = i % slots
        if i >= slots:
            ds = engine.free_slot(ds, slot)
        prefix = engine.prefill(params, toks)
        ds = engine.insert(prefix, ds, slot)
    pending = None
    for _ in range(gen_steps):
        ds, res = engine.generate(params, ds)
        if pending is not None and drain is not None:
            drain(pending)
        pending = res
    if pending is not None and drain is not None:
        drain(pending)
    return ds


_TARGET_CACHE: dict = {}


def get_target(name: str, device=None) -> AnalysisTarget:
    """Process-wide cache per (name, device): params/engine construction
    dominates analysis runtime, and passes are read-only over the engine
    geometry (each pass that needs traffic re-inits the decode state
    itself)."""
    from repro_torch import resolve_device
    key = (name, str(resolve_device(device)))
    if key not in _TARGET_CACHE:
        _TARGET_CACHE[key] = build_target(name, device)
    return _TARGET_CACHE[key]
