"""rwkv6-1.6b [ssm] "Finch": 24L d_model=2048 (attention-free, data-dependent
decay) d_ff=7168 vocab=65536. O(1) per-layer state. [arXiv:2404.05892;
unverified]

Every block is an RWKV-6 time mix and channel mix behind LayerNorms
(``models.rwkv``); there is no attention, so the config serves on dense
per-slot states only (a paged engine has no cache to page) and prefills at
the exact prompt length. ``n_layers`` cuts the depth and keeps every
width; SOI compresses layers ``[n_layers // 4, n_layers - n_layers // 4)``
(6..18 at full depth).
"""

from repro_torch.configs.base import (BlockCfg, ModelCfg, RWKVCfg, Segment,
                                      SOILMCfg)


def _cfg(n_layers, d, heads, hd, ff, vocab, soi=None):
    block = BlockCfg(
        rwkv=RWKVCfg(n_heads=heads, head_dim=hd, decay_lora=64, mix_lora=32,
                     d_ff=ff),
        norm="layernorm",
    )
    soi_cfg = None
    if soi:
        soi_cfg = SOILMCfg(first_layer=n_layers // 4,
                           last_layer=n_layers - n_layers // 4, mode=soi)
    return ModelCfg(
        name="rwkv6-1.6b", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(block,), n_layers=n_layers),),
        tie_embeddings=False, soi=soi_cfg,
        supports_long_context=True,
    )


def config(soi=None, n_layers: int = 24) -> ModelCfg:
    return _cfg(n_layers, 2048, 32, 64, 7168, 65536, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(4, 64, 4, 16, 224, 256, soi)
