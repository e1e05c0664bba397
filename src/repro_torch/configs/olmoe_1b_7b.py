"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (MHA kv=16) — 64 experts top-8,
d_expert=1024, vocab=50304, qk-norm. [arXiv:2409.02060; hf]

``n_layers`` cuts the depth and keeps every width; SOI compresses layers
``[n_layers // 4, n_layers - n_layers // 4)`` (4..12 at full depth). A MoE
config cannot mask pad: it prefills at the exact prompt length
(``models.decode.supports_masked_prefill``).
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, ModelCfg, MoECfg,
                                      Segment, SOILMCfg)


def _cfg(n_layers, d, heads, kv, hd, n_experts, top_k, d_expert, vocab,
         soi=None):
    block = BlockCfg(
        attn=AttnCfg(kind="gqa", n_heads=heads, n_kv=kv, head_dim=hd,
                     qk_norm=True),
        moe=MoECfg(n_experts=n_experts, top_k=top_k, d_expert=d_expert,
                   capacity_factor=1.25, mlp_kind="swiglu"),
        norm="rmsnorm",
    )
    soi_cfg = None
    if soi:
        soi_cfg = SOILMCfg(first_layer=n_layers // 4,
                           last_layer=n_layers - n_layers // 4, mode=soi)
    return ModelCfg(
        name="olmoe-1b-7b", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(block,), n_layers=n_layers),),
        tie_embeddings=False, soi=soi_cfg,
    )


def config(soi=None, n_layers: int = 16) -> ModelCfg:
    return _cfg(n_layers, 2048, 16, 16, 128, 64, 8, 1024, 50304, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(4, 64, 4, 4, 16, 8, 2, 48, 256, soi)
