"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768. [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

``n_layers`` cuts the depth and keeps every width (the 88 layers hold
245 GB in bf16; one H100 holds 16 of them beside the serving state); SOI
compresses layers ``[n_layers // 4, n_layers - n_layers // 4)`` (22..66
at full depth, 4..12 at 16 layers).
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, MLPCfg, ModelCfg,
                                      Segment, SOILMCfg)


def _cfg(n_layers, d, heads, kv, hd, ff, vocab, soi=None):
    block = BlockCfg(
        attn=AttnCfg(kind="gqa", n_heads=heads, n_kv=kv, head_dim=hd,
                     rope_theta=1e6),
        mlp=MLPCfg(kind="swiglu", d_ff=ff),
        norm="rmsnorm",
    )
    soi_cfg = None
    if soi:
        soi_cfg = SOILMCfg(first_layer=n_layers // 4,
                           last_layer=n_layers - n_layers // 4, mode=soi)
    return ModelCfg(
        name="mistral-large-123b", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(block,), n_layers=n_layers),),
        tie_embeddings=False, soi=soi_cfg,
    )


def config(soi=None, n_layers: int = 88) -> ModelCfg:
    return _cfg(n_layers, 12288, 96, 8, 128, 28672, 32768, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(4, 64, 8, 2, 8, 160, 256, soi)
