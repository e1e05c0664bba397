"""``decode_attention(..., return_lse=True)`` and ``ref.merge_partials`` on
the CPU (their plain versions; the CUDA kernel is held to them in
tests/test_torch_kernels_gpu.py and chip_smoke.py phase 24):

  * ``lse`` against a float64 log-sum-exp of the reference's scores
    (``repro.kernels.ref.decode_attention``'s einsum, soft cap and mask,
    in numpy) within ``LSE_TOL``, and ``out`` against the reference's read
    within ``OUT_TOL``; without the flag the read is the same tensor bit
    for bit;
  * the cache split into M = 2, 4 shards of its rows (a dense ring and a
    wrapped windowed one), each shard read with its ``lse`` and merged in
    rank order: the unsharded read within ``MERGE_TOL`` (float32);
  * a shard that holds no visible row reads out 0 and lse -inf, and merges
    with weight 0; a slot that no shard sees merges to 0, never NaN;
  * bfloat16 partials merge in float32 to within bf16 rounding of the
    float32 merge;
  * the same three for the plain absorbed MLA read
    ``ops.mla_decode_attention(..., return_lse=True)`` (no TPU kernel: the
    tensor-parallel serve step's read of a split latent ring): ``lse``
    against a float64 log-sum-exp of the reference's scores
    (``repro.kernels.ref.mla_decode_attention``'s two einsums and mask),
    ``out`` against the reference's read, shards merged within
    ``MERGE_TOL``, a dead shard out 0 and lse -inf.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

torch.set_num_threads(1)

LSE_TOL = 1e-5        # float32 logsumexp vs float64
OUT_TOL = 2e-5        # port plain vs reference (tests/test_torch_kernels.py)
MERGE_TOL = 1e-6      # merged shards vs the unsharded read, float32


def _inputs(seed, b, h, hkv, s, dh, *, ring=False, t_lo=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    t = rng.integers(s // 2, s + 4, size=b).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if ring:
        tt = t[:, None] + s // 2
        l = np.arange(s)[None]
        pos = (tt - 1 - ((tt - 1 - l) % s)).astype(np.int32)
        t = (tt[:, 0] - 1).astype(np.int32)
    if t_lo is not None:        # slot 0 sees only the first rows
        t[0] = t_lo
    pos[:, -3:] = -1
    return q, k, v, pos, t


def _reference_lse(q, k, pos, t, *, window=None, softcap=None):
    """float64 log-sum-exp of the reference's masked scores; -inf where no
    key is live."""
    b, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dh).astype(np.float64)
    s = np.einsum("bhgd,bkhd->bhgk", qg, k.astype(np.float64)) * dh ** -0.5
    if softcap:
        s = softcap * np.tanh(s / softcap)
    allow = (pos >= 0) & (pos <= t[:, None])
    if window is not None:
        allow &= pos > t[:, None] - window
    s = np.where(allow[:, None, None], s, -np.inf)
    top = s.max(-1, keepdims=True)
    safe = np.where(np.isfinite(top), top, 0.0)
    with np.errstate(divide="ignore"):
        lse = np.log(np.exp(s - safe).sum(-1)) + safe[..., 0]
    return lse.reshape(b, h)


CASES = {
    "gqa2": dict(b=2, h=4, hkv=2, s=32, dh=16),
    "mqa": dict(b=3, h=8, hkv=1, s=40, dh=32),
    "ring_window": dict(b=3, h=8, hkv=4, s=32, dh=32, ring=True, window=11),
    "softcap": dict(b=2, h=4, hkv=2, s=24, dh=16, softcap=5.0),
    "early_slot": dict(b=2, h=4, hkv=2, s=32, dh=16, t_lo=5),
}


def _split(case):
    kw = dict(CASES[case])
    return kw.pop("window", None), kw.pop("softcap", None), kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_is_the_float64_log_sum_exp(case):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    window, softcap, kw = _split(case)
    q, k, v, pos, t = _inputs(1, **kw)
    args = [torch.from_numpy(x) for x in (q, k, v, pos, t)]
    out, lse = ops.decode_attention(*args, window=window,
                                    logit_softcap=softcap, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    want = _reference_lse(q, k, pos, t, window=window, softcap=softcap)
    assert np.isfinite(want).all()
    assert float(np.abs(lse.numpy() - want).max()) < LSE_TOL
    ref_out = jref.decode_attention(*map(jnp.asarray, (q, k, v, pos, t)),
                                    window=window, logit_softcap=softcap)
    assert float(np.abs(out.numpy() - np.asarray(ref_out)).max()) < OUT_TOL
    plain = ops.decode_attention(*args, window=window, logit_softcap=softcap)
    assert torch.equal(plain, out)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_merged_shards_are_the_unsharded_read(case, m):
    window, softcap, kw = _split(case)
    q, k, v, pos, t = (torch.from_numpy(x) for x in _inputs(2, **kw))
    want = ops.decode_attention(q, k, v, pos, t, window=window,
                                logit_softcap=softcap)
    s = k.shape[1]
    rows = s // m
    outs, lses = [], []
    for r in range(m):
        sl = slice(r * rows, (r + 1) * rows)
        o, l = ops.decode_attention(
            q, k[:, sl].contiguous(), v[:, sl].contiguous(),
            pos[:, sl].contiguous(), t, window=window,
            logit_softcap=softcap, return_lse=True)
        outs.append(o)
        lses.append(l)
    got = pref.merge_partials(torch.stack(outs), torch.stack(lses))
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < MERGE_TOL


def test_a_shard_that_sees_no_row_weighs_zero():
    """Slot 0 at t 5 sees rows 0..5 only: the other shards read out 0 and
    lse -inf; a slot whose every row is empty merges to 0, not NaN."""
    q, k, v, pos, t = (torch.from_numpy(x) for x in _inputs(
        3, b=3, h=4, hkv=2, s=32, dh=16, t_lo=5))
    pos[2] = -1                                   # a free slot
    outs, lses = [], []
    for r in range(4):
        sl = slice(r * 8, (r + 1) * 8)
        o, l = ops.decode_attention(q, k[:, sl].contiguous(),
                                    v[:, sl].contiguous(),
                                    pos[:, sl].contiguous(), t,
                                    return_lse=True)
        outs.append(o)
        lses.append(l)
        if r:
            assert torch.isneginf(l[0]).all() and not o[0].any()
        assert torch.isneginf(l[2]).all() and not o[2].any()
        assert not torch.isnan(o).any() and not torch.isnan(l).any()
    got = pref.merge_partials(torch.stack(outs), torch.stack(lses))
    want = ops.decode_attention(q, k, v, pos, t)
    assert not torch.isnan(got).any()
    assert float((got[:2] - want[:2]).abs().max()) < MERGE_TOL
    assert not got[2].any()


def test_bfloat16_partials_merge_in_float32():
    q, k, v, pos, t = (torch.from_numpy(x) for x in _inputs(
        4, b=2, h=8, hkv=4, s=32, dh=16))
    parts = [ops.decode_attention(q, k[:, sl].contiguous(),
                                  v[:, sl].contiguous(),
                                  pos[:, sl].contiguous(), t,
                                  return_lse=True)
             for sl in (slice(0, 16), slice(16, 32))]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([l for _, l in parts])
    f32 = pref.merge_partials(outs, lses)
    bf = pref.merge_partials(outs.to(torch.bfloat16), lses)
    assert bf.dtype == torch.bfloat16
    # two bf16 roundings (the partials', the result's) of values < 4
    assert float((bf.float() - f32).abs().max()) < 2 * 4 * 2 ** -8


def test_cpu_route_launches_nothing():
    q, k, v, pos, t = (torch.from_numpy(x) for x in _inputs(
        5, b=1, h=2, hkv=1, s=8, dh=16))
    ops.reset_launch_counts()
    out, lse = ops.decode_attention(q, k, v, pos, t, return_lse=True)
    assert out.shape == q.shape and lse.shape == (1, 2)
    assert ops.launch_counts()["decode_attention"] == 0


def _mla_inputs(seed, b, h, s, lat, rope, *, t_lo=None):
    rng = np.random.default_rng(seed)
    q_lat = rng.standard_normal((b, h, lat)).astype(np.float32)
    q_rope = rng.standard_normal((b, h, rope)).astype(np.float32)
    latent = rng.standard_normal((b, s, lat)).astype(np.float32)
    k_rope = rng.standard_normal((b, s, rope)).astype(np.float32)
    t = rng.integers(s // 2, s + 4, size=b).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if t_lo is not None:        # slot 0 sees only the first rows
        t[0] = t_lo
    pos[:, -3:] = -1
    return q_lat, q_rope, latent, k_rope, pos, t


MLA_CASES = {"h4": dict(b=2, h=4, s=32, lat=24, rope=8),
             "h8_wide": dict(b=3, h=8, s=40, lat=64, rope=16),
             "early_slot": dict(b=2, h=4, s=32, lat=24, rope=8, t_lo=5)}
MLA_SCALE = 24 ** -0.5


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_lse_is_the_float64_log_sum_exp(case):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    q_lat, q_rope, latent, k_rope, pos, t = _mla_inputs(1, **MLA_CASES[case])
    args = [torch.from_numpy(x) for x in (q_lat, q_rope, latent, k_rope, pos,
                                          t)]
    out, lse = ops.mla_decode_attention(*args, scale=MLA_SCALE,
                                        return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == q_lat.shape[:2]
    f64 = (np.einsum("bhl,bsl->bhs", q_lat.astype(np.float64),
                     latent.astype(np.float64))
           + np.einsum("bhk,bsk->bhs", q_rope.astype(np.float64),
                       k_rope.astype(np.float64))) * MLA_SCALE
    allow = (pos >= 0) & (pos <= t[:, None])
    f64 = np.where(allow[:, None], f64, -np.inf)
    top = f64.max(-1, keepdims=True)
    want = np.log(np.exp(f64 - top).sum(-1)) + top[..., 0]
    assert np.isfinite(want).all()
    assert float(np.abs(lse.numpy() - want).max()) < LSE_TOL
    ref_out = jref.mla_decode_attention(
        *map(jnp.asarray, (q_lat, q_rope, latent, k_rope, pos, t)),
        scale=MLA_SCALE)
    assert float(np.abs(out.numpy() - np.asarray(ref_out)).max()) < OUT_TOL
    plain = ops.mla_decode_attention(*args, scale=MLA_SCALE)
    assert torch.equal(plain, out)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_merged_shards_are_the_unsharded_read(case, m):
    q_lat, q_rope, latent, k_rope, pos, t = (
        torch.from_numpy(x) for x in _mla_inputs(2, **MLA_CASES[case]))
    want = ops.mla_decode_attention(q_lat, q_rope, latent, k_rope, pos, t,
                                    scale=MLA_SCALE)
    rows = latent.shape[1] // m
    outs, lses = [], []
    for r in range(m):
        sl = slice(r * rows, (r + 1) * rows)
        o, l = ops.mla_decode_attention(
            q_lat, q_rope, latent[:, sl], k_rope[:, sl], pos[:, sl], t,
            scale=MLA_SCALE, return_lse=True)
        outs.append(o)
        lses.append(l)
    got = pref.merge_partials(torch.stack(outs), torch.stack(lses))
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < MERGE_TOL


def test_mla_shard_that_sees_no_row_weighs_zero():
    """Slot 0 at t 5 sees rows 0..5 only: the other shards read out 0 and
    lse -inf; a slot whose every row is empty merges to 0, not NaN."""
    q_lat, q_rope, latent, k_rope, pos, t = (
        torch.from_numpy(x) for x in _mla_inputs(
            3, b=3, h=4, s=32, lat=24, rope=8, t_lo=5))
    pos[2] = -1                                   # a free slot
    outs, lses = [], []
    for r in range(4):
        sl = slice(r * 8, (r + 1) * 8)
        o, l = ops.mla_decode_attention(q_lat, q_rope, latent[:, sl],
                                        k_rope[:, sl], pos[:, sl], t,
                                        scale=MLA_SCALE, return_lse=True)
        outs.append(o)
        lses.append(l)
        if r:
            assert torch.isneginf(l[0]).all() and not o[0].any()
        assert torch.isneginf(l[2]).all() and not o[2].any()
        assert not torch.isnan(o).any() and not torch.isnan(l).any()
    got = pref.merge_partials(torch.stack(outs), torch.stack(lses))
    want = ops.mla_decode_attention(q_lat, q_rope, latent, k_rope, pos, t,
                                    scale=MLA_SCALE)
    assert not torch.isnan(got).any()
    assert float((got[:2] - want[:2]).abs().max()) < MERGE_TOL
    assert not got[2].any()
