"""repro_torch model vs the JAX reference on the CPU: offline forward,
prefill into decode caches, and bucketed (padded + true-length) prefill.

Every parameter leaf — RMSNorm scales included — is redrawn with numpy
before it is carried across, so a port that read the norm as ``scale``
instead of ``1 + scale`` (the reference's convention) would fail here.
Sizes: qwen3 smoke config in float32 (4 layers, d=64, 4/2 heads, vocab 256).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.qwen3_1_7b as Q
from repro.distributed.sharding import split_axes
from repro.models import decode as JD
from repro.models import transformer as JT
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.convert import from_jax_params
from repro_torch.models import decode as PD
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

S = 16
ATOL = 1e-4          # the reference's own cross-program bound (test_prefill)
FWD_ATOL = 1e-4


def _cfgs(mode):
    jc = dataclasses.replace(Q.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(PQ.smoke_config(soi=mode), dtype="float32")
    return jc, pc


def _random_params(cfg, seed=0):
    """A parameter tree of the reference's structure and shapes (from an
    abstract init) with every leaf drawn by numpy: fan-in scaled weights,
    unit-variance embeddings, and nonzero norm scales."""
    shapes, _ = split_axes(jax.eval_shape(
        lambda k: JT.init(k, cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(x):
        if len(x.shape) == 1:
            s = 0.3                                   # norm scales
        elif x.shape[0] == cfg.vocab:
            s = 1.0                                   # embedding
        elif len(x.shape) == 3 and x.shape[-1] == cfg.d_model:
            s = float(np.prod(x.shape[:-1])) ** -0.5  # wo, soi compress
        else:
            s = x.shape[0] ** -0.5
        return (rng.standard_normal(x.shape) * s).astype(np.float32)

    return jax.tree.map(draw, shapes)


@functools.lru_cache(maxsize=None)
def _setup(mode, seed=0):
    jc, pc = _cfgs(mode)
    np_params = _random_params(jc, seed)
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = from_jax_params(np_params, pc, device="cpu")
    tokens = np.random.default_rng(seed + 1).integers(
        0, jc.vocab, (2, S)).astype(np.int32)
    return jc, pc, jparams, model, tokens


def _layers(jstate_group):
    """Unstack the reference's scanned per-segment caches into per-layer
    dicts (k, v, pos)."""
    out = []
    for seg in jstate_group:
        attn = seg["sub0"]["attn"]
        for i in range(attn["pos"].shape[0]):
            out.append({k: np.asarray(v[i]) for k, v in attn.items()})
    return out


def _groups(cfg):
    return ("segments",) if cfg.soi is None else ("pre", "mid", "post")


def _assert_state_close(jstate, pstate, cfg, where):
    np.testing.assert_array_equal(pstate["t"].numpy(),
                                  np.asarray(jstate["t"]), err_msg=where)
    for g in _groups(cfg):
        jl = _layers(jstate[g])
        assert len(jl) == len(pstate[g]), (where, g)
        for i, (jc, pc) in enumerate(zip(jl, pstate[g])):
            np.testing.assert_array_equal(pc["pos"].numpy(), jc["pos"],
                                          err_msg=f"{where} {g}[{i}] pos")
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    pc[name].numpy(), jc[name], atol=ATOL, rtol=0,
                    err_msg=f"{where} {g}[{i}] {name}")
    if cfg.soi is not None:
        for name in ("conv_buf", "queue"):
            np.testing.assert_allclose(pstate[name].numpy(),
                                       np.asarray(jstate[name]), atol=ATOL,
                                       rtol=0, err_msg=f"{where} {name}")


def _assert_port_states_equal(ref, got, cfg, where):
    assert torch.equal(ref["t"], got["t"]), where
    for g in _groups(cfg):
        for i, (a, b) in enumerate(zip(ref[g], got[g])):
            assert torch.equal(a["pos"], b["pos"]), (where, g, i)
            for name in ("k", "v"):
                torch.testing.assert_close(b[name], a[name], atol=ATOL,
                                           rtol=0, msg=f"{where} {g}[{i}]")
    if cfg.soi is not None:
        for name in ("conv_buf", "queue"):
            torch.testing.assert_close(got[name], ref[name], atol=ATOL,
                                       rtol=0, msg=f"{where} {name}")


@pytest.mark.parametrize("mode", [None, "pp", "fp"])
def test_forward_matches_reference(mode):
    jc, pc, jparams, model, tokens = _setup(mode)
    ref = np.asarray(jax.jit(lambda p, t: JT.forward(p, jc, t))(
        jparams, jnp.asarray(tokens)))
    got = PT.forward(model, pc, torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (2, S, jc.vocab)
    err = float(np.max(np.abs(got - ref)))
    assert err < FWD_ATOL, (mode, err)


@pytest.mark.parametrize("mode", [None, "pp", "fp"])
def test_prefill_matches_reference(mode):
    """Prefill at lengths on and off the stride fills the same caches,
    clocks, conv window and queue as the reference; clocks and position
    lanes exactly. The reference runs as one compiled bucketed prefill
    (padded to S, masked by true length), which tests/test_prefill.py holds
    equal to its unpadded prefill."""
    jc, pc, jparams, model, tokens = _setup(mode)
    jprefill = jax.jit(lambda pr, tk, tl: JD.prefill(pr, jc, tk, max_len=S,
                                                     true_length=tl))
    for p in (5, 6, 8):
        padded = np.pad(tokens[:, :p], ((0, 0), (0, S - p)))
        jl, js = jprefill(jparams, jnp.asarray(padded),
                          jnp.asarray(p, jnp.int32))
        pl, ps = PD.prefill(model, pc, torch.from_numpy(tokens[:, :p]),
                            max_len=S)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"{mode} p={p}")
        _assert_state_close(js, ps, pc, f"{mode} p={p}")


@pytest.mark.parametrize("mode", [None, "pp", "fp"])
def test_bucketed_prefill_matches_unpadded(mode):
    """Padded prefill with true_length reproduces the unpadded prefill's
    whole state (as tests/test_prefill.py holds the reference), incl.
    prompts shorter than the stride."""
    _, pc, _, model, tokens = _setup(mode)
    tt = torch.from_numpy(tokens[:1])
    for p in (1, 3, 5, 8, 11):
        lg_ref, st_ref = PD.prefill(model, pc, tt[:, :p], max_len=S)
        padded = torch.nn.functional.pad(tt[:, :p], (0, S - p))
        lg, st = PD.prefill(model, pc, padded, max_len=S, true_length=p)
        torch.testing.assert_close(lg, lg_ref, atol=ATOL, rtol=0,
                                   msg=f"{mode} p={p}")
        _assert_port_states_equal(st_ref, st, pc, f"{mode} p={p}")


def test_bf16_cast_runs_in_compute_dtype():
    """The smoke config computes in bf16: the masters cast once and the
    logits come out float32 and finite."""
    cfg = PQ.smoke_config(soi="pp")
    model = PT.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    assert model.embed.dtype == torch.float32
    tokens = torch.randint(0, cfg.vocab, (1, 7), dtype=torch.int32)
    logits, state = PD.prefill(model, cfg, tokens, max_len=S)
    assert model.embed.dtype == torch.bfloat16
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert state["pre"][0]["k"].dtype == torch.bfloat16
