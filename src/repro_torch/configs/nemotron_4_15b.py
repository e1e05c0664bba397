"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — squared-ReLU MLP, LayerNorm, partial (50%) rotary.
[arXiv:2402.16819; unverified]

LayerNorm blocks carry a bias beside each scale, and so does the final
norm; the squared-ReLU MLP has ``up`` and ``down`` only. ``n_layers`` cuts
the depth and keeps every width; SOI compresses layers ``[n_layers // 4,
n_layers - n_layers // 4)`` (8..24 at full depth).
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, MLPCfg, ModelCfg,
                                      Segment, SOILMCfg)


def _cfg(n_layers, d, heads, kv, hd, ff, vocab, soi=None):
    block = BlockCfg(
        attn=AttnCfg(kind="gqa", n_heads=heads, n_kv=kv, head_dim=hd,
                     rope_pct=0.5),
        mlp=MLPCfg(kind="relu2", d_ff=ff),
        norm="layernorm",
    )
    soi_cfg = None
    if soi:
        soi_cfg = SOILMCfg(first_layer=n_layers // 4,
                           last_layer=n_layers - n_layers // 4, mode=soi)
    return ModelCfg(
        name="nemotron-4-15b", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(block,), n_layers=n_layers),),
        tie_embeddings=False, soi=soi_cfg,
    )


def config(soi=None, n_layers: int = 32) -> ModelCfg:
    return _cfg(n_layers, 6144, 48, 8, 128, 24576, 256000, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(4, 64, 4, 2, 16, 224, 256, soi)
