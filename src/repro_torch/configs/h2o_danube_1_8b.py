"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention (ring-buffer KV
=> runs the long_500k decode shape). [arXiv:2401.16818; hf]

Every attention layer keeps a ring of ``min(max_len, window)`` rows
(``models.attention.init_cache``), so a prompt longer than the 4096-token
window wraps it. ``n_layers`` cuts the depth and keeps every width; SOI
compresses layers ``[n_layers // 4, n_layers - n_layers // 4)`` (6..18 at
full depth).
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, MLPCfg, ModelCfg,
                                      Segment, SOILMCfg)

WINDOW = 4096


def _cfg(n_layers, d, heads, kv, hd, ff, vocab, window, soi=None):
    block = BlockCfg(
        attn=AttnCfg(kind="gqa", n_heads=heads, n_kv=kv, head_dim=hd,
                     window=window),
        mlp=MLPCfg(kind="swiglu", d_ff=ff),
        norm="rmsnorm",
    )
    soi_cfg = None
    if soi:
        soi_cfg = SOILMCfg(first_layer=n_layers // 4,
                           last_layer=n_layers - n_layers // 4, mode=soi)
    return ModelCfg(
        name="h2o-danube-1.8b", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(block,), n_layers=n_layers),),
        tie_embeddings=False, soi=soi_cfg,
        supports_long_context=True, decode_only_window=window,
    )


def config(soi=None, n_layers: int = 24) -> ModelCfg:
    return _cfg(n_layers, 2560, 32, 8, 80, 6912, 32000, WINDOW, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(4, 64, 4, 2, 16, 160, 256, 8, soi)
