"""repro_torch layer primitives vs the JAX reference on the CPU, float32,
tolerance 1e-6: RMSNorm with a random nonzero scale (the (1 + scale)
convention), interleaved-pair RoPE at theta=1e6 with per-slot positions,
SwiGLU, and the strided causal conv behind the SOI compress."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLPCfg
from repro.core import stmc as jstmc
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro_torch.core import stmc as pstmc
from repro_torch.models import layers as players
from repro_torch.models import mlp as pmlp

torch.set_num_threads(1)

TOL = 1e-6


def _close(got, want, tol=TOL):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err < tol, err


def test_rmsnorm_one_plus_scale():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = (0.3 * rng.standard_normal(64)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           eps=1e-6)
    got = players.norm_apply("rmsnorm", torch.from_numpy(scale),
                             torch.from_numpy(x), eps=1e-6)
    _close(got, want)
    # the scale really enters as (1 + scale)
    plain = players.rmsnorm(torch.zeros(64), torch.from_numpy(x))
    assert not torch.allclose(plain, got)


def test_layernorm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    scale, bias = (0.3 * rng.standard_normal((2, 32))).astype(np.float32)
    want = jlayers.norm_apply("layernorm", {"scale": jnp.asarray(scale),
                                            "bias": jnp.asarray(bias)},
                              jnp.asarray(x))
    got = players.norm_apply("layernorm", torch.from_numpy(scale),
                             torch.from_numpy(x), bias=torch.from_numpy(bias))
    _close(got, want)


@pytest.mark.parametrize("heads", [True, False])
def test_rope_interleaved_per_slot_positions(heads):
    rng = np.random.default_rng(2)
    shape = (3, 6, 4, 16) if heads else (3, 6, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4000, size=(3, 6)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6)
    got = players.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta=1e6)
    _close(got, want)
    np.testing.assert_allclose(
        players.rope_freqs(16, theta=1e6).numpy(),
        np.asarray(jlayers.rope_freqs(16, theta=1e6)), rtol=1e-6)


def test_swiglu():
    rng = np.random.default_rng(3)
    d, ff = 64, 192
    x = (0.5 * rng.standard_normal((2, 5, d))).astype(np.float32)
    w = {"up": rng.standard_normal((d, ff)) * d ** -0.5,
         "gate": rng.standard_normal((d, ff)) * d ** -0.5,
         "down": rng.standard_normal((ff, d)) * ff ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    cfg = MLPCfg(kind="swiglu", d_ff=ff)
    want = jmlp.mlp_apply({k: jnp.asarray(v) for k, v in w.items()}, cfg,
                          jnp.asarray(x))
    m = pmlp.MLP(cfg, d, generator=torch.Generator(), device="cpu")
    with torch.no_grad():
        for k, v in w.items():
            getattr(m, k).copy_(torch.from_numpy(v))
    _close(pmlp.mlp_apply(m, torch.from_numpy(x)), want)


@pytest.mark.parametrize("k,stride,dilation,t", [
    (2, 2, 1, 9),        # the SOI compress: width = stride = 2, odd length
    (2, 2, 1, 8),
    (3, 1, 2, 11),
    (4, 3, 1, 10),
])
def test_causal_conv1d(k, stride, dilation, t):
    rng = np.random.default_rng(4)
    x = (0.5 * rng.standard_normal((2, t, 24))).astype(np.float32)
    w = (rng.standard_normal((k, 24, 16)) * (k * 24) ** -0.5).astype(
        np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = jstmc.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=stride, dilation=dilation)
    got = pstmc.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), stride=stride,
                              dilation=dilation)
    _close(got, want)
