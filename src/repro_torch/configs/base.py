"""Unified LM configuration schema (the port's own copy of
``repro.configs.base``; the dataclasses are unchanged so a config built for
one package describes the same model in the other).

A model is a stack of *segments*; each segment is n_layers of one BlockCfg.
The port runs one ``Block`` module per layer, so a segment is a contiguous
run of layers rather than a stacked, scanned parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    kind: str = "gqa"            # gqa | mla | bidir | cross
    n_heads: int = 16
    n_kv: int = 8
    head_dim: int = 128
    qk_norm: bool = False        # qwen3-style per-head RMSNorm on q,k
    window: Optional[int] = None # sliding-window / local attention
    rope: bool = True
    rope_pct: float = 1.0        # nemotron: partial rotary
    rope_theta: float = 1e4
    softmax_scale: Optional[float] = None
    logit_softcap: Optional[float] = None
    # MLA (DeepSeek-V2) dims
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0

    @property
    def is_mla(self) -> bool:
        return self.kind == "mla"


@dataclasses.dataclass(frozen=True)
class MLPCfg:
    kind: str = "swiglu"         # swiglu | geglu | relu2 | gelu
    d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 0
    n_shared: int = 0            # DeepSeek shared experts
    d_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    mlp_kind: str = "swiglu"


@dataclasses.dataclass(frozen=True)
class RGLRUCfg:
    width: int = 0               # recurrence width (== d_model in Griffin)
    n_heads: int = 0             # block-diagonal gate heads
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    n_heads: int = 32
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    d_ff: int = 0                # channel-mix width


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One transformer block: a sequence mixer + a channel mixer."""
    attn: Optional[AttnCfg] = None
    rglru: Optional[RGLRUCfg] = None
    rwkv: Optional[RWKVCfg] = None       # rwkv time-mix (rwkv6)
    mlp: Optional[MLPCfg] = None
    moe: Optional[MoECfg] = None
    cross_attn: Optional[AttnCfg] = None # enc-dec decoder blocks
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    gemma_scale: bool = False            # (1+scale) RMSNorm convention
    post_norm: bool = False


@dataclasses.dataclass(frozen=True)
class Segment:
    """n_layers of a repeating pattern of BlockCfgs, scanned if homogeneous.

    ``blocks`` is the repeating pattern (usually length 1; RecurrentGemma uses
    (rec, rec, attn)). n_layers counts *individual* layers and must be a
    multiple of len(blocks) when scan=True.
    """
    blocks: tuple        # tuple[BlockCfg, ...]
    n_layers: int
    scan: bool = True

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.blocks) == 0
        return self.n_layers // len(self.blocks)


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    """Auxiliary (bidirectional) encoder — whisper audio encoder."""
    segments: tuple
    n_frames: int = 1500
    d_model: int = 384


@dataclasses.dataclass(frozen=True)
class SOILMCfg:
    """SOI applied to an LM stack: temporal stride-`stride` compression of
    layers [first_layer, last_layer) with duplication extrapolation + skip
    fusion (paper's S-CC pair at token granularity); "fp" adds the time shift
    (scattered decode can then precompute the middle between tokens)."""
    first_layer: int = 0
    last_layer: int = 0
    mode: str = "pp"             # pp | fp
    stride: int = 2
    extrapolation: str = "dup"


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str = "model"
    d_model: int = 0
    vocab: int = 0
    segments: tuple = ()
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logits_softcap: Optional[float] = None
    embed_scale: bool = False      # gemma: multiply embeddings by sqrt(d)
    frontend: Optional[str] = None # "patch_stub" | "audio_stub"
    frontend_len: int = 0          # prefix length provided by the stub
    encoder: Optional[EncoderCfg] = None
    prefix_lm: bool = False        # bidirectional attention over the prefix
    soi: Optional[SOILMCfg] = None
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save matmul outputs) | none
    dtype: str = "bfloat16"
    learned_pos_len: int = 0       # whisper-style learned position table
    # which shapes are runnable (sub-quadratic archs support long_500k)
    supports_long_context: bool = False
    decode_only_window: Optional[int] = None  # ring-buffer KV if windowed

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.segments)


# The assigned input-shape suite (arch-family-generic), as the reference
# defines it: what the dry run (launch/dryrun.py) lays out over a mesh.
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}
