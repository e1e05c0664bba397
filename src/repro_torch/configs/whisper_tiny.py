"""whisper-tiny [audio]: enc-dec — 4L encoder (bidirectional) + 4L decoder
(causal self-attn + cross-attn), d_model=384 6H d_ff=1536 vocab=51865, GELU,
LayerNorm, learned decoder positions. Conv frontend is a STUB: the caller
provides the 1500 precomputed mel-frame embeddings. [arXiv:2212.04356;
unverified]

The encoder's blocks attend bidirectionally (``kind="bidir"``); every
decoder block reads the encoder output through cross attention
(``kind="cross"``), whose K/V a prefill computes once per request and the
decode state keeps per slot. ``n_layers`` cuts the decoder's depth (the
encoder keeps its 4 layers) and keeps every width.
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, EncoderCfg, MLPCfg,
                                      ModelCfg, Segment, SOILMCfg)

N_FRAMES = 1500


def _cfg(n_enc, n_dec, d, heads, hd, ff, vocab, n_frames, max_pos, soi=None):
    self_attn = AttnCfg(kind="gqa", n_heads=heads, n_kv=heads, head_dim=hd,
                        rope=False)
    enc_attn = AttnCfg(kind="bidir", n_heads=heads, n_kv=heads, head_dim=hd,
                       rope=False)
    cross = AttnCfg(kind="cross", n_heads=heads, n_kv=heads, head_dim=hd,
                    rope=False)
    dec_block = BlockCfg(attn=self_attn, cross_attn=cross,
                         mlp=MLPCfg(kind="gelu", d_ff=ff), norm="layernorm")
    enc_block = BlockCfg(attn=enc_attn, mlp=MLPCfg(kind="gelu", d_ff=ff),
                         norm="layernorm")
    soi_cfg = None
    if soi:
        soi_cfg = SOILMCfg(first_layer=n_dec // 4,
                           last_layer=n_dec - max(1, n_dec // 4), mode=soi)
    return ModelCfg(
        name="whisper-tiny", d_model=d, vocab=vocab,
        segments=(Segment(blocks=(dec_block,), n_layers=n_dec),),
        tie_embeddings=True, learned_pos_len=max_pos,
        frontend="audio_stub",
        encoder=EncoderCfg(
            segments=(Segment(blocks=(enc_block,), n_layers=n_enc),),
            n_frames=n_frames, d_model=d),
        soi=soi_cfg,
    )


def config(soi=None, n_layers: int = 4) -> ModelCfg:
    # max_pos sized for the decode_32k assigned shape (real whisper caps at
    # 448; the table is the only change needed for the 32k cell).
    return _cfg(4, n_layers, 384, 6, 64, 1536, 51865, N_FRAMES, 32768, soi)


def smoke_config(soi=None) -> ModelCfg:
    return _cfg(2, 2, 32, 2, 16, 96, 256, 16, 128, soi)
