"""deepseek-v2-236b [moe]: 60L d_model=5120, MLA (kv_lora=512, q_lora=1536,
qk_nope=128, qk_rope=64, v_head=128, 128H), MoE 160 routed experts top-6 +
2 shared (d_expert=1536), first layer dense (d_ff=12288), vocab=102400.
[arXiv:2405.04434; hf]

``n_layers`` cuts the depth and keeps every width: layer 0 stays the dense
block, the rest are MoE blocks, and SOI compresses layers
``[max(1, n//4), n - n//4)`` as in the 60-layer config.

``mla_dense_config`` is the MLA stack with a dense MLP: ``n_layers`` copies
of deepseek-v2's own layer-0 block (MLA + SwiGLU d_ff 12288). MoE blocks
cannot mask pad, so only such a stack takes chunked prefill and the prefix
cache (``repro_torch.models.decode.supports_masked_prefill``).
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, MLPCfg, ModelCfg,
                                      MoECfg, Segment, SOILMCfg)


def _mla(heads, q_lora, kv_lora, qk_nope, qk_rope, v_head):
    return AttnCfg(kind="mla", n_heads=heads, n_kv=heads,
                   head_dim=qk_nope + qk_rope, q_lora=q_lora, kv_lora=kv_lora,
                   qk_nope=qk_nope, qk_rope=qk_rope, v_head=v_head)


def _soi(n_layers, soi):
    if not soi:
        return None
    return SOILMCfg(first_layer=max(1, n_layers // 4),
                    last_layer=n_layers - n_layers // 4, mode=soi)


def _cfg(n_layers, d, heads, q_lora, kv_lora, qk_nope, qk_rope, v_head,
         dense_ff, n_experts, top_k, d_expert, n_shared, vocab, soi=None):
    attn = _mla(heads, q_lora, kv_lora, qk_nope, qk_rope, v_head)
    dense = BlockCfg(attn=attn, mlp=MLPCfg(kind="swiglu", d_ff=dense_ff))
    moe = BlockCfg(attn=attn,
                   moe=MoECfg(n_experts=n_experts, top_k=top_k,
                              d_expert=d_expert, n_shared=n_shared,
                              d_shared=d_expert, capacity_factor=1.25,
                              mlp_kind="swiglu"))
    return ModelCfg(
        name="deepseek-v2-236b", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(dense,), n_layers=1, scan=False),
                  Segment(blocks=(moe,), n_layers=n_layers - 1)),
        tie_embeddings=False, soi=_soi(n_layers, soi),
    )


def config(soi=None, n_layers: int = 60) -> ModelCfg:
    return _cfg(n_layers, 5120, 128, 1536, 512, 128, 64, 128,
                12288, 160, 6, 1536, 2, 102400, soi)


def smoke_config(soi=None, n_layers: int = 5) -> ModelCfg:
    return _cfg(n_layers, 64, 4, 32, 24, 16, 8, 16, 160, 8, 2, 32, 1, 256,
                soi)


def mla_dense_config(soi=None, n_layers: int = 4) -> ModelCfg:
    """``n_layers`` of deepseek-v2's layer-0 block (MLA + SwiGLU) at full
    width, with its untied head."""
    attn = _mla(128, 1536, 512, 128, 64, 128)
    dense = BlockCfg(attn=attn, mlp=MLPCfg(kind="swiglu", d_ff=12288))
    return ModelCfg(
        name="deepseek-v2-236b-mla-dense", d_model=5120, vocab=102400,
        segments=(Segment(blocks=(dense,), n_layers=n_layers),),
        tie_embeddings=False, soi=_soi(n_layers, soi))
