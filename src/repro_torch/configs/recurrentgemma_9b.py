"""recurrentgemma-9b [hybrid]: 38L d_model=4096 (RG-LRU + local attention 1:2
pattern), attn 16H (MQA kv=1, head_dim 256, window 2048), d_ff=12288 GeGLU,
vocab=256000, tied embeddings scaled by sqrt(d), logits soft-capped at 30.
[arXiv:2402.19427]

``n_layers`` cuts the depth and keeps every width: ``n_layers // 3``
(RG-LRU, RG-LRU, attention) patterns, then ``n_layers % 3`` RG-LRU layers
(38 -> 12 patterns + 2). SOI compresses layers ``[first, last)`` with both
bounds aligned to the 3-block pattern, as in the reference: 9..27 at full
depth, 3..9 at 12 layers, 0..3 in the 6-layer smoke config.
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, MLPCfg, ModelCfg,
                                      RGLRUCfg, Segment, SOILMCfg)

WINDOW = 2048


def _cfg(n_pattern, extra_rec, d, heads, hd, ff, vocab, window, lru_heads,
         soi=None):
    rec = BlockCfg(
        rglru=RGLRUCfg(width=d, n_heads=lru_heads, conv_width=4),
        mlp=MLPCfg(kind="geglu", d_ff=ff),
        norm="rmsnorm",
    )
    att = BlockCfg(
        attn=AttnCfg(kind="gqa", n_heads=heads, n_kv=1, head_dim=hd,
                     window=window, rope_theta=1e4),
        mlp=MLPCfg(kind="geglu", d_ff=ff),
        norm="rmsnorm",
    )
    segs = [Segment(blocks=(rec, rec, att), n_layers=3 * n_pattern)]
    if extra_rec:
        segs.append(Segment(blocks=(rec,), n_layers=extra_rec))
    n_layers = 3 * n_pattern + extra_rec
    soi_cfg = None
    if soi:
        # align SOI boundaries with the 3-block pattern
        first = (n_layers // 4) // 3 * 3
        last = (n_layers - n_layers // 4) // 3 * 3
        soi_cfg = SOILMCfg(first_layer=first, last_layer=last, mode=soi)
    return ModelCfg(
        name="recurrentgemma-9b", d_model=d, vocab=vocab,
        segments=tuple(segs), tie_embeddings=True, embed_scale=True,
        logits_softcap=30.0, soi=soi_cfg,
        supports_long_context=True, decode_only_window=window,
    )


def config(soi=None, n_layers: int = 38) -> ModelCfg:
    return _cfg(n_layers // 3, n_layers % 3, 4096, 16, 256, 12288, 256000,
                WINDOW, 16, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(2, 0, 64, 4, 16, 160, 256, 8, 4, soi)
