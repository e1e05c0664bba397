"""Training of the encoder-decoder, prefix-LM, RWKV and LayerNorm /
plain-MLP stacks against the JAX reference on the CPU, at smoke width in
float32, with the weights drawn as ``tests/test_torch_train_families.py``
draws them (its ``GAIN``):

  * ``loss_fn``'s value and the gradient of every parameter against
    ``jax.value_and_grad(repro.models.transformer.loss_fn)`` on the same
    numpy weights, within 1e-5 of each leaf's largest |value|:
    whisper-tiny over random ``encoder_frames`` (the encoder's gradients
    included), paligemma-3b behind random ``patch_embeds`` (no SOI and
    pp; the loss over the token positions only), rwkv6-1.6b (no SOI and
    pp) and nemotron-4-15b (LayerNorm with its biases, squared ReLU, pp);
  * three ``make_train_step`` steps of whisper-tiny, paligemma-3b and
    recurrentgemma-9b against the jitted JAX step;
  * at gain 1 (``tests/test_torch_train.py``'s draw), for these four as
    ``test_torch_train_families.py`` does for its families: the port's
    float32 gradients and the reference's are about equally far from a
    float64 run of the port, leaf by leaf (within 10x of each other), so
    the reduced gains test the port and not the rounding;
  * ``launch.train.main`` on the CPU for each of the four architectures;
  * the mesh steps' layout check of RWKV, encoder-decoder and prefix-LM
    stacks, which they refused on more than one rank until
    ``tests/test_torch_sharded_families.py`` held their runs: passed
    where the model axis divides their heads, refused where it cuts
    one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as pconfigs
from repro_torch.convert import from_jax_params
from repro_torch.launch import train as ptrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw_init
from test_torch_train import _random_params as _gain1_params
from test_torch_train_families import (B, BOUNDS, S, STEP_KW, TOL, _by_name,
                                       _cfgs, _random_params, _rel,
                                       _share_off, check_rounding_alike,
                                       jax_run, port_grads)

torch.set_num_threads(1)

# (arch, SOI mode): every family this slice trains
CASES = [("whisper-tiny", None), ("paligemma-3b", None),
         ("paligemma-3b", "pp"), ("rwkv6-1.6b", None), ("rwkv6-1.6b", "pp"),
         ("nemotron-4-15b", "pp")]
ARCHS = ("whisper-tiny", "paligemma-3b", "rwkv6-1.6b", "nemotron-4-15b")


def _stubs(jc, rng) -> dict:
    """Random stub frontends of the config: patch embeddings (B, P, d) and
    encoder frames (B, n_frames, d_enc)."""
    out = {}
    if jc.frontend == "patch_stub":
        out["patch_embeds"] = rng.standard_normal(
            (B, jc.frontend_len, jc.d_model)).astype(np.float32)
    if jc.encoder is not None:
        out["encoder_frames"] = rng.standard_normal(
            (B, jc.encoder.n_frames, jc.encoder.d_model)).astype(np.float32)
    return out


def _batch(jc) -> dict:
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    targets = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    targets[0, :3] = -1                       # masked positions
    targets[2, -2:] = -1
    return {"tokens": tokens, "targets": targets, **_stubs(jc, rng)}


@functools.lru_cache(maxsize=None)
def _setup(arch, mode):
    jc, pc = _cfgs(arch, mode)
    return jc, pc, _random_params(jc), _batch(jc)


@pytest.mark.parametrize("arch,mode", CASES)
def test_loss_and_every_grad_match_jax(arch, mode):
    jc, pc, params, batch = _setup(arch, mode)
    (jl, jm), jg = jax_run(arch, mode, params, batch)
    loss, metrics, got = port_grads(pc, params, batch)
    assert _rel(loss, jl) < TOL
    assert _rel(metrics["xent"], jm["xent"]) < TOL
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    want = _by_name(jg, pc)
    assert set(got) == set(want)
    if jc.encoder is not None:
        assert any(k.startswith("encoder.") for k in want)
    for k in want:
        assert got[k] is not None, k
        assert _rel(got[k], want[k]) < TOL, k


def _steps_match(jc, pc, params, batch, steps=3):
    """``steps`` make_train_step steps of the port against the jitted JAX
    step on the same numpy weights, the tokens and targets rolled a
    position a step: metrics each step, then params and moments."""
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(jmake_train_step(jc, **STEP_KW))
    jopt = jadamw_init(jparams)
    model = from_jax_params(params, pc, device="cpu")
    pstep = make_train_step(pc, **STEP_KW)
    popt = adamw_init(dict(model.named_parameters()))
    lr_sum = 0.0
    for step in range(steps):
        rolled = {k: (np.roll(v, step, axis=1) if k in ("tokens", "targets")
                      else v) for k, v in batch.items()}
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v)
                                   for k, v in rolled.items()})
        model, popt, pm = pstep(model, popt, {k: torch.from_numpy(v)
                                              for k, v in rolled.items()})
        assert set(pm) == set(jm)
        for k in jm:
            if float(jm[k]) == 0.0:
                assert float(pm[k]) == 0.0, (step, k)
            else:
                assert _rel(pm[k], jm[k]) < (TOL if step == 0
                                             else 10 * TOL), (step, k)
        lr_sum += float(jm["lr"])
    assert int(popt["count"]) == int(jopt["count"]) == steps
    trees = {"params": (model.state_dict(), _by_name(jparams, pc))}
    trees.update({t: (popt[t], _by_name(jopt[t], pc)) for t in ("mu", "nu")})
    for t, (got, want) in trees.items():
        assert set(got) == set(want), t
        bound, share = BOUNDS[t]
        assert _share_off(got, want, bound) <= share, t
    got, want = trees["params"]
    for k, w in want.items():
        assert float(np.abs(got[k].numpy() - w).max()) <= lr_sum, k


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b",
                                  "recurrentgemma-9b"])
def test_three_steps_match_jax(arch):
    """recurrentgemma-9b's case closes the question of its rising loss in
    the card's 10 full-width steps: the port's steps are the reference's."""
    jc, pc, params, _ = _setup(arch, None)
    _steps_match(jc, pc, params, _batch(jc))


@pytest.mark.parametrize("arch,mode", [
    ("whisper-tiny", None), ("paligemma-3b", "pp"), ("rwkv6-1.6b", "pp"),
    ("nemotron-4-15b", "pp")])
def test_gain_one_rounding_is_alike(arch, mode, monkeypatch):
    """The same check as test_torch_train_families.py's for this slice's
    four: at gain 1 the port's and the reference's float32 gradients sit
    equally far (within 10x) from a float64 run of the port."""
    jc, pc, _, batch = _setup(arch, mode)
    check_rounding_alike(arch, mode, pc, _gain1_params(jc), batch,
                         monkeypatch)


# ---------------------------------------------------------------------------
# the training entry point and the mesh refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_on_the_cpu(arch, capsys):
    losses = ptrain.main(["--device", "cpu", "--smoke", "--arch", arch,
                          "--steps", "3", "--batch", "2", "--seq", "16",
                          "--log-every", "1"])
    assert len(losses) == 3 and all(np.isfinite(losses)), losses
    assert "done: 3 steps" in capsys.readouterr().out


def test_stub_batch_is_the_reference_trainers():
    """zero patch embeddings and frames of 0.1 in bfloat16, as
    ``repro.launch.train``'s ``extra_batch`` makes them."""
    pali = pconfigs.get_smoke("paligemma-3b")
    whisper = pconfigs.get_smoke("whisper-tiny")
    p = ptrain.stub_batch(pali, 3, "cpu")
    assert set(p) == {"patch_embeds"}
    assert p["patch_embeds"].shape == (3, pali.frontend_len, pali.d_model)
    assert p["patch_embeds"].dtype == torch.bfloat16
    assert not p["patch_embeds"].any()
    w = ptrain.stub_batch(whisper, 2, "cpu")
    assert set(w) == {"encoder_frames"}
    assert w["encoder_frames"].shape == (2, whisper.encoder.n_frames,
                                         whisper.encoder.d_model)
    assert torch.equal(w["encoder_frames"],
                       torch.full_like(w["encoder_frames"], 0.1))
    assert ptrain.stub_batch(pconfigs.get_smoke("rwkv6-1.6b"), 2,
                             "cpu") == {}


@pytest.mark.parametrize("arch,shape,what", [
    ("rwkv6-1.6b", {"data": 2, "model": 2}, None),
    ("rwkv6-1.6b", {"data": 1, "model": 8}, "rwkv heads 4 % mesh 8"),
    ("whisper-tiny", {"data": 2, "model": 2}, None),
    ("whisper-tiny", {"data": 1, "model": 4}, "'heads' dim 2 % mesh 4"),
    ("paligemma-3b", {"data": 2, "model": 2}, None),
    ("paligemma-3b", {"data": 4, "model": 1}, None)])
def test_mesh_step_refuses_unsharded_stacks(arch, shape, what):
    """RWKV, encoder-decoder and prefix-LM stacks on more than one rank:
    no longer refused as stacks — the layout check of the train step and
    of both serving steps, which needs no process group, passes them
    wherever the model axis divides their heads; a model axis that cuts
    a head (4 RWKV heads on 8 ranks, whisper smoke's 2 on 4) stays
    refused (ROADMAP.md Queue 1 item 8)."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import steps as PS
    cfg = pconfigs.get_smoke(arch)
    make_train_step(cfg)                          # trains without a mesh
    rules = ShardingRules(data_axes=("data",))
    for step in ("train", "serve"):
        if what is None:
            PS._check_layout(cfg, rules, shape["model"], step)
            continue
        with pytest.raises(NotImplementedError,
                           match=f"{step} step does not run.*{what}.*"
                                 f"Queue 1 item 8"):
            PS._check_layout(cfg, rules, shape["model"], step)
