"""paligemma-3b [vlm]: gemma-2b text backbone — 18L d_model=2048 8H (MQA kv=1,
head_dim 256) d_ff=16384 GeGLU vocab=257216 + SigLIP image frontend (STUB:
the caller provides 256 precomputed patch embeddings at d_model); prefix-LM
attention over the image prefix. [arXiv:2407.07726; hf]

The first ``frontend_len`` positions of a prefill attend bidirectionally
(``prefix_lm``), so the config prefills at the exact prompt length, on the
plain prefix-LM attention on every device, as the reference routes it.
``n_layers`` cuts the depth and keeps every width; SOI compresses layers
``[n_layers // 4, n_layers - n_layers // 4)``.
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, MLPCfg, ModelCfg,
                                      Segment, SOILMCfg)

N_PATCHES = 256


def _cfg(n_layers, d, heads, kv, hd, ff, vocab, n_patches, soi=None):
    block = BlockCfg(
        attn=AttnCfg(kind="gqa", n_heads=heads, n_kv=kv, head_dim=hd),
        mlp=MLPCfg(kind="geglu", d_ff=ff),
        norm="rmsnorm",
    )
    soi_cfg = None
    if soi:
        soi_cfg = SOILMCfg(first_layer=n_layers // 4,
                           last_layer=n_layers - n_layers // 4, mode=soi)
    return ModelCfg(
        name="paligemma-3b", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(block,), n_layers=n_layers),),
        tie_embeddings=True, embed_scale=True,
        frontend="patch_stub", frontend_len=n_patches, prefix_lm=True,
        soi=soi_cfg,
    )


def config(soi=None, n_layers: int = 18) -> ModelCfg:
    return _cfg(n_layers, 2048, 8, 1, 256, 16384, 257216, N_PATCHES, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(4, 64, 4, 1, 16, 192, 256, 8, soi)
