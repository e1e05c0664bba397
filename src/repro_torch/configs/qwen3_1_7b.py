"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936,
qk_norm. [hf:Qwen/Qwen3-8B family; hf]

Reference SOI-LM config: ``config(soi="pp"|"fp")`` compresses the middle half
of the stack (layers 7..21) — the paper-representative serving cell.
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, MLPCfg, ModelCfg,
                                      Segment, SOILMCfg)


def _cfg(n_layers, d, heads, kv, hd, ff, vocab, soi=None):
    block = BlockCfg(
        attn=AttnCfg(kind="gqa", n_heads=heads, n_kv=kv, head_dim=hd,
                     qk_norm=True, rope_theta=1e6),
        mlp=MLPCfg(kind="swiglu", d_ff=ff),
        norm="rmsnorm",
    )
    soi_cfg = None
    if soi:
        soi_cfg = SOILMCfg(first_layer=n_layers // 4,
                           last_layer=n_layers - n_layers // 4, mode=soi)
    return ModelCfg(
        name="qwen3-1.7b", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(block,), n_layers=n_layers),),
        tie_embeddings=True, soi=soi_cfg,
    )


def config(soi=None, n_layers: int = 28) -> ModelCfg:
    return _cfg(n_layers, 2048, 16, 8, 128, 6144, 151936, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(4, 64, 4, 2, 16, 192, 256, soi)
