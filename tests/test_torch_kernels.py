"""Attention kernels of repro_torch.

On the CPU: the plain PyTorch versions (what every wrapper runs for a CPU
tensor) against the JAX reference — ``repro.kernels.ref`` and the Pallas
kernels in interpret mode, called as tests/test_kernels.py calls them.
Tolerance ``max|Δ| < 2e-5`` in float32, the "f32 ULP" class of
docs/KERNELS.md.

The CUDA kernels against these plain versions on the card are in
tests/test_torch_kernels_gpu.py, which imports no JAX.
"""

import jax  # noqa: F401  (JAX on the CPU, as conftest.py sets)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as JDA
from repro.kernels import flash_attention as JFA
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as PDA
from repro_torch.kernels import flash_attention as PFA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

torch.set_num_threads(1)

def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _decode_inputs(seed, b, h, hkv, s, dh, *, ring=False, inactive=False):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, h, dh))
    k = _normal(rng, (b, s, hkv, dh))
    v = _normal(rng, (b, s, hkv, dh))
    t = rng.integers(s // 2, s + 4, size=b).astype(np.int32)  # per slot
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if ring:
        # ring buffer that wrapped: slot l holds the newest p with p%s == l
        tt = t[:, None] + s // 2
        l = np.arange(s)[None]
        pos = (tt - 1 - ((tt - 1 - l) % s)).astype(np.int32)
        t = (tt[:, 0] - 1).astype(np.int32)
    pos[:, -3:] = -1                                     # empty lanes
    if inactive:
        pos[-1] = -1                                     # a free slot
    return q, k, v, pos, t


def _close(got, want, tol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert np.isfinite(got).all() and err < tol, err


DECODE_CASES = {
    "gqa2": dict(b=2, h=4, hkv=2, s=37, dh=16),
    "gqa1": dict(b=2, h=4, hkv=4, s=40, dh=16),
    "ring_window": dict(b=3, h=8, hkv=4, s=29, dh=32, ring=True, window=11),
    "inactive": dict(b=2, h=4, hkv=2, s=24, dh=16, inactive=True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_plain_decode_attention_matches_reference(case):
    kw = dict(DECODE_CASES[case])
    win = kw.pop("window", None)
    q, k, v, pos, t = _decode_inputs(1, **kw)
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos),
                                 jnp.asarray(t), window=win)
    args = [torch.from_numpy(x) for x in (q, k, v, pos, t)]
    got = ops.decode_attention(*args, window=win)
    _close(got, want)
    if case != "inactive":
        # the Pallas kernel pads S to its block with empty lanes, so a slot
        # with no live key averages over the pad too: only live slots match
        pallas = JDA.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            jnp.asarray(t), window=win, block_k=16, interpret=True)
        _close(got, pallas)


def test_decode_attention_softcap_plain_path():
    q, k, v, pos, t = _decode_inputs(2, 2, 4, 2, 20, 16)
    want = jref.decode_attention(*map(jnp.asarray, (q, k, v, pos, t)),
                                 logit_softcap=5.0)
    got = pref.decode_attention(*map(torch.from_numpy, (q, k, v, pos, t)),
                                logit_softcap=5.0)
    _close(got, want)


def _flash_inputs(seed, b, sq, sk, h, hkv, dh):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, sq, h, dh)), _normal(rng, (b, sk, hkv, dh)),
            _normal(rng, (b, sk, hkv, dh)))


FLASH_CASES = {
    "gqa2": dict(b=2, sq=37, sk=37, h=4, hkv=2, dh=16),
    "gqa1": dict(b=1, sq=33, sk=33, h=2, hkv=2, dh=32),
    "offset_softcap": dict(b=2, sq=12, sk=40, h=4, hkv=2, dh=16, q_offset=28,
                           cap=20.0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_flash_attention_matches_reference(case):
    kw = dict(FLASH_CASES[case])
    qo = kw.pop("q_offset", 0)
    cap = kw.pop("cap", None)
    q, k, v = _flash_inputs(3, **kw)
    g = kw["h"] // kw["hkv"]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jref.chunked_flash_attention(jq, jk, jv, causal=True, q_offset=qo,
                                        logit_softcap=cap, block_q=8,
                                        block_k=16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=qo,
                              logit_softcap=cap)
    _close(got, want)
    # small blocks: ragged edges and skipped past-diagonal key blocks
    blocked = pref.flash_attention(tq, tk, tv, causal=True, q_offset=qo,
                                   logit_softcap=cap, block_q=8, block_k=16)
    _close(blocked, want)
    if case == "gqa2":
        _close(got, jref.naive_attention(jq, jk, jv, causal=True))
    # the Pallas kernel takes repeated KV heads (GQA resolved upstream)
    pallas = JFA.flash_attention(jq, jnp.repeat(jk, g, axis=2),
                                 jnp.repeat(jv, g, axis=2), causal=True,
                                 q_offset=qo, logit_softcap=cap, block_q=16,
                                 block_k=16, interpret=True)
    _close(got, pallas)


def test_plain_flash_attention_window_and_noncausal():
    q, k, v = _flash_inputs(4, 2, 40, 40, 4, 2, 16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(ops.flash_attention(tq, tk, tv, window=8),
           jref.naive_attention(jq, jk, jv, causal=True, window=8))
    _close(pref.flash_attention(tq, tk, tv, causal=False, block_q=16,
                                block_k=8),
           jref.naive_attention(jq, jk, jv, causal=False))


def test_cpu_tensors_never_count_launches():
    ops.reset_launch_counts()
    q, k, v, pos, t = _decode_inputs(5, 1, 2, 1, 8, 16)
    ops.decode_attention(*map(torch.from_numpy, (q, k, v, pos, t)))
    fq, fk, fv = _flash_inputs(5, 1, 8, 8, 2, 1, 16)
    ops.flash_attention(*map(torch.from_numpy, (fq, fk, fv)))
    assert ops.launch_counts() == {"decode_attention": 0,
                                   "flash_attention": 0}


def test_unsupported_devices_raise():
    x = torch.zeros(1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PDA.decode_attention(x, x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        PFA.flash_attention(x, x, x)
