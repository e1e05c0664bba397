"""The pieces nemotron-4-15b brought into repro_torch, on the CPU, against
the JAX package: LayerNorm through ``norm_apply`` (its eps at least 1e-5),
the plain squared-ReLU and GeLU MLPs (no ``gate``) and SwiGLU through
``mlp_apply``, the weight bridge on nemotron's LayerNorm + relu2 tree
(every bias carried, a leaf missing or left over refused), and
``check_trainable`` accepting LayerNorm, plain-MLP, RWKV and
encoder-decoder stacks (held against the JAX trainer in
tests/test_torch_train_zoo.py) and refusing only an attention logit
softcap on the card (the CUDA flash backward takes none).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.nemotron_4_15b as JNM
from repro.configs.base import MLPCfg as JMLPCfg
from repro.distributed.sharding import split_axes
from repro.models import layers as JL
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch import configs as pconfigs
from repro_torch.configs import nemotron_4_15b as PNM
from repro_torch.configs.base import MLPCfg
from repro_torch.convert import from_jax_params
from repro_torch.models import layers as PL
from repro_torch.models import mlp as PM
from repro_torch.models import transformer as PT

torch.set_num_threads(1)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 2 + 0.5
    scale = rng.standard_normal(48).astype(np.float32) * 0.3
    bias = rng.standard_normal(48).astype(np.float32) * 0.3
    for eps in (1e-6, 1e-3):       # LayerNorm's eps is at least 1e-5
        want = JL.norm_apply("layernorm", {"scale": jnp.asarray(scale),
                                           "bias": jnp.asarray(bias)},
                             jnp.asarray(x), eps=eps)
        got = PL.norm_apply("layernorm", torch.from_numpy(scale),
                            torch.from_numpy(x), bias=torch.from_numpy(bias),
                            eps=eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("kind", ["relu2", "gelu", "swiglu"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(4)
    d, ff = 24, 40
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    jp, _ = split_axes(JM.mlp_init(jax.random.PRNGKey(1),
                                   JMLPCfg(kind=kind, d_ff=ff), d))
    jp = jax.tree.map(np.asarray, jp)
    assert ("gate" in jp) == (kind == "swiglu")
    model = PM.MLP(MLPCfg(kind=kind, d_ff=ff), d,
                   generator=torch.Generator(), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in jp.items()})
    want = JM.mlp_apply(jp, JMLPCfg(kind=kind, d_ff=ff), jnp.asarray(x))
    got = PM.mlp_apply(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_bridge_carries_layernorm_biases_and_a_gateless_mlp():
    """nemotron's tree: every block's ln1/ln2 and the final norm carry a
    bias, its MLPs no gate; the port's model holds the same numbers, and a
    tree with a leaf missing or left over is refused."""
    jc = dataclasses.replace(JNM.smoke_config(soi="pp"), dtype="float32")
    pc = dataclasses.replace(PNM.smoke_config(soi="pp"), dtype="float32")
    jp, _ = split_axes(JT.init(jax.random.PRNGKey(7), jc))
    jp = jax.tree.map(np.asarray, jp)
    # the init draws zero norms: give every leaf distinct numbers
    rng = np.random.default_rng(8)
    jp = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), jp)
    model = from_jax_params(jp, pc, device="cpu")
    seg = jp["segments"][0]["sub0"]
    assert "gate" not in seg["mlp"]
    for i, bp in enumerate(model.blocks):
        assert not hasattr(bp.mlp, "gate") and bp.bcfg.mlp.kind == "relu2"
        for name in ("ln1", "ln2"):
            for leaf, attr in (("scale", name), ("bias", name + "_bias")):
                assert np.array_equal(getattr(bp, attr).detach().numpy(),
                                      seg[name][leaf][i]), (i, attr)
        for name in ("up", "down"):
            assert np.array_equal(getattr(bp.mlp, name).detach().numpy(),
                                  seg["mlp"][name][i])
    assert np.array_equal(model.final_norm_bias.detach().numpy(),
                          jp["final_norm"]["bias"])
    assert "final_norm_bias" in dict(model.named_parameters())
    missing = jax.tree.map(lambda x: x, jp)
    del missing["final_norm"]["bias"]
    with pytest.raises(ValueError, match="missing.*final_norm_bias"):
        from_jax_params(missing, pc, device="cpu")
    extra = jax.tree.map(lambda x: x, jp)
    extra["segments"][0]["sub0"]["mlp"]["gate"] = seg["mlp"]["up"]
    with pytest.raises(ValueError, match="unexpected.*mlp.gate"):
        from_jax_params(extra, pc, device="cpu")
    # an RMSNorm stack has no bias parameters at all
    rms = PT.init(pconfigs.get_smoke("mistral-large-123b"),
                  generator=torch.Generator(), device="cpu")
    assert not any(n.endswith("_bias") for n, _ in rms.named_parameters())


@pytest.mark.parametrize("arch,kind", [
    ("nemotron-4-15b", "LayerNorm"), ("whisper-tiny", "encoder-decoder"),
    ("relu2-rmsnorm", "relu2 MLP"), ("rwkv6-1.6b", "RWKV")])
def test_check_trainable_refuses_what_is_not_held(arch, kind):
    if arch == "relu2-rmsnorm":
        cfg = pconfigs.get_smoke("qwen3-1.7b")
        seg = cfg.segments[0]
        blk = dataclasses.replace(seg.blocks[0],
                                  mlp=MLPCfg(kind="relu2", d_ff=64))
        cfg = dataclasses.replace(cfg, segments=(dataclasses.replace(
            seg, blocks=(blk,)),))
    else:
        cfg = pconfigs.get_smoke(arch)
    # the stack of `kind` trains on every device
    for device in ("cpu", "cuda"):
        PT.check_trainable(cfg, device)
    # an attention logit softcap is refused on the card only, and not
    # inside a window (the plain windowed route takes it)
    capped = _with_attn(cfg, logit_softcap=30.0)
    if capped is not None:
        PT.check_trainable(capped, "cpu")
        with pytest.raises(NotImplementedError,
                           match="logit_softcap.*Queue 1 item 7"):
            PT.check_trainable(capped, "cuda")
        PT.check_trainable(_with_attn(cfg, logit_softcap=30.0, window=8),
                           "cuda")
    # windowed attention, MoE, MLA and RG-LRU stacks train
    for ok in ("mistral-large-123b", "h2o-danube-1.8b", "olmoe-1b-7b",
               "deepseek-v2-236b", "recurrentgemma-9b"):
        PT.check_trainable(pconfigs.get_smoke(ok), "cuda")


def _with_attn(cfg, **kw):
    """``cfg`` with ``kw`` set on every attention of its decoder and
    encoder blocks, or None without attention."""
    def blocks(segs):
        return tuple(dataclasses.replace(seg, blocks=tuple(
            dataclasses.replace(b, **{
                f: dataclasses.replace(getattr(b, f), **kw)
                for f in ("attn", "cross_attn") if getattr(b, f) is not None})
            for b in seg.blocks)) for seg in segs)
    if not any(b.attn is not None for b in PT.layer_blocks(cfg)):
        return None
    out = dataclasses.replace(cfg, segments=blocks(cfg.segments))
    if cfg.encoder is not None:
        out = dataclasses.replace(out, encoder=dataclasses.replace(
            cfg.encoder, segments=blocks(cfg.encoder.segments)))
    return out
