"""The flash-attention gradient on the CPU: the plain
``ref.flash_attention_bwd`` (the recompute scheme the CUDA backward
follows) against autograd of the plain forward and against ``jax.vjp`` of
``repro.kernels.ref.chunked_flash_attention`` (the reference's gradient:
it has no backward kernel), and ``ref.attention_lse`` against JAX's
logsumexp of the masked scores. Causal and not, GQA at G 1 and 2, a
``q_offset`` > 0 with Sq != Sk, ragged blocks, d_v < d_qk (MLA); float32,
within 1e-5 of
each gradient's largest |value|. Then the grad guard: on the CPU,
``ops.flash_attention`` (and the model's attention) still differentiates
through the plain forward, and ``_build.refuse_grad`` — the check every
other kernel's CUDA route makes — raises exactly when grad mode is on and
an input requires grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as PFA
from repro_torch.kernels import ref as pref

torch.set_num_threads(1)

TOL = 1e-5

# (B, Sq, Sk, H, Hkv, dh, q_offset, causal)
CASES = {
    "causal-g2": (2, 24, 24, 4, 2, 16, 0, True),
    "causal-g1": (1, 17, 17, 2, 2, 32, 0, True),
    "offset-sq<sk": (2, 9, 21, 4, 2, 16, 12, True),
    "offset-mqa": (1, 5, 14, 4, 1, 8, 9, True),
    "noncausal-g2": (2, 11, 19, 4, 2, 16, 0, False),
    # MLA's shape of heads: d_v < d_qk (deepseek-v2: 192 / 128)
    "mla-dv<dqk": (2, 13, 13, 4, 4, (24, 16), 0, True),
}


def _inputs(case, seed=0):
    b, sq, sk, h, hkv, dh, off, causal = CASES[case]
    dqk, dv = dh if isinstance(dh, tuple) else (dh, dh)
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(b, sq, h, dqk), f(b, sk, hkv, dqk), f(b, sk, hkv, dv),
            f(b, sq, h, dv), off, causal)


def _rel(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plain_bwd(q, k, v, do, off, causal):
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o = pref.flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    lse = pref.attention_lse(tq, tk, causal=causal, q_offset=off)
    return pref.flash_attention_bwd(tq, tk, tv, o, torch.from_numpy(do), lse,
                                    causal=causal, q_offset=off)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_autograd_of_plain_forward(case):
    q, k, v, do, off, causal = _inputs(case)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = pref.flash_attention(tq, tk, tv, causal=causal, q_offset=off,
                             block_q=4, block_k=8)     # ragged blocks
    want = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for got, w in zip(_plain_bwd(q, k, v, do, off, causal), want):
        assert _rel(got, w) < TOL


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_jax_vjp(case):
    q, k, v, do, off, causal = _inputs(case, seed=1)
    fn = lambda q_, k_, v_: jref.chunked_flash_attention(
        q_, k_, v_, causal=causal, q_offset=off, block_q=8, block_k=8)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for got, w in zip(_plain_bwd(q, k, v, do, off, causal), want):
        assert _rel(got, w) < TOL


@pytest.mark.parametrize("case", ["causal-g2", "offset-sq<sk",
                                  "noncausal-g2"])
def test_lse_matches_jax(case):
    q, k, _, _, off, causal = _inputs(case, seed=2)
    b, sq, sk, h, hkv, dh, _, _ = CASES[case]
    s = jnp.einsum("bqhgd,bkhd->bhgqk",
                   jnp.asarray(q).reshape(b, sq, hkv, h // hkv, dh),
                   jnp.asarray(k)) * dh ** -0.5
    allow = jref._mask(off + jnp.arange(sq), jnp.arange(sk), causal=causal,
                       window=None, prefix_len=0)
    want = jax.nn.logsumexp(jnp.where(allow, s, jref.NEG_INF),
                            axis=-1).reshape(b, h, sq)
    got = pref.attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                             causal=causal, q_offset=off)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_wrapper_takes_the_plain_bwd_on_the_cpu():
    q, k, v, do, off, causal = _inputs("offset-sq<sk")
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = pref.flash_attention(tq, tk, tv, q_offset=off)
    lse = pref.attention_lse(tq, tk, q_offset=off)
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(tq, tk, tv, o, tdo, lse, q_offset=off)
    want = pref.flash_attention_bwd(tq, tk, tv, o, tdo, lse, q_offset=off)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    # the backward kernel takes every pair the forward does, MLA's too
    assert PFA.HEAD_DIMS == ((16, 16), (32, 32), (64, 64), (128, 128),
                             (192, 128))


def test_cpu_route_still_differentiates():
    """ops.flash_attention with grad on, on the CPU: the plain forward
    under autograd — the same gradient as the plain backward."""
    q, k, v, do, off, causal = _inputs("causal-g2", seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, _plain_bwd(q, k, v, do, off, causal)):
        assert _rel(g, w) < TOL
    # the windowed route differentiates on the CPU too
    ow = ops.flash_attention(tq, tk, tv, window=5)
    assert ow.grad_fn is not None


def test_refuse_grad_is_a_flag_check():
    x = torch.zeros(2, requires_grad=True)
    y = torch.zeros(2)
    with pytest.raises(NotImplementedError, match="no backward"):
        _build.refuse_grad("lru_scan", y, x)
    _build.refuse_grad("lru_scan", y, None)          # nothing needs grad
    with torch.no_grad():
        _build.refuse_grad("lru_scan", x)            # grad mode off
    assert _build.needs_grad(x) and not _build.needs_grad(y, None)
