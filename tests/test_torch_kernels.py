"""Kernels of repro_torch: decode, flash and chunk attention, the paged
decode read, and the batched page copy.

On the CPU: the plain PyTorch versions (what every wrapper runs for a CPU
tensor) against the JAX reference — ``repro.kernels.ref`` / ``ops`` and
the Pallas kernels in interpret mode, called as tests/test_kernels.py calls
them. Tolerance ``max|Δ| < 2e-5`` in float32, the "f32 ULP" class of
docs/KERNELS.md; ``copy_pages`` is bit-exact, and the plain paged read is
bit-exact against the plain dense read of the same logical rows.

The CUDA kernels against these plain versions on the card are in
tests/test_torch_kernels_gpu.py, which imports no JAX.
"""

import jax  # noqa: F401  (JAX on the CPU, as conftest.py sets)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_attention as JCA
from repro.kernels import decode_attention as JDA
from repro.kernels import flash_attention as JFA
from repro.kernels import ops as jops
from repro.kernels import page_copy as JPC
from repro.kernels import ref as jref
from repro_torch.kernels import chunk_attention as PCA
from repro_torch.kernels import decode_attention as PDA
from repro_torch.kernels import flash_attention as PFA
from repro_torch.kernels import ops
from repro_torch.kernels import page_copy as PPC
from repro_torch.kernels import ref as pref
from repro_torch.models.attention import paged_view

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
    args = _chunk_inputs(5, 1, 4, 12, 2, 1, 16)
    ops.chunk_attention(*map(torch.from_numpy, args))
    pargs = _paged_inputs(5, 2, 4, 2, 16, 4, 3, 7)
    ops.paged_decode_attention(*map(torch.from_numpy, pargs))
    pool = torch.zeros(3, 4)
    ops.copy_pages(pool, torch.tensor([1], dtype=torch.int32),
                   torch.tensor([2], dtype=torch.int32))
    ql, qr = torch.randn(1, 4, 4, 16), torch.randn(1, 4, 4, 8)
    lat, rope = torch.randn(1, 6, 16), torch.randn(1, 6, 8)
    pos = torch.arange(6, dtype=torch.int32)[None]
    ops.mla_chunk_attention(ql, qr, lat, rope, pos[:, 2:], pos, scale=0.2)
    ops.paged_mla_decode_attention(
        ql[:, 0], qr[:, 0], lat.reshape(3, 2, 16), rope.reshape(3, 2, 8),
        pos.reshape(3, 2), torch.tensor([[2, 1]], dtype=torch.int32),
        torch.tensor([3], dtype=torch.int32), scale=0.2)
    ops.lru_scan(torch.rand(1, 3, 4), torch.rand(1, 3, 4))
    ops.stmc_conv(torch.rand(2, 3, 4), torch.rand(3, 4, 5), torch.rand(5))
    assert ops.launch_counts() == {"decode_attention": 0,
                                   "flash_attention": 0,
                                   "chunk_attention": 0,
                                   "paged_decode_attention": 0,
                                   "copy_pages": 0,
                                   "mla_chunk_attention": 0,
                                   "paged_mla_decode_attention": 0,
                                   "lru_scan": 0,
                                   "stmc_conv": 0}


def test_unsupported_devices_raise():
    x = torch.zeros(1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PDA.decode_attention(x, x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        PFA.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        PCA.chunk_attention(x, x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        PDA.paged_decode_attention(x, x, x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        PPC.copy_pages(x, x, x)


# ---------------------------------------------------------------------------
# chunk_attention
# ---------------------------------------------------------------------------

def _chunk_inputs(seed, b, c, sk, h, hkv, dh, *, filled=None, q0=None,
                  pad_rows=0, ring=False):
    """C queries at positions q0.. (the last ``pad_rows`` of them at -1)
    against a cache of ``sk - c`` rows plus the chunk's own c keys."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, c, h, dh))
    k = _normal(rng, (b, sk, hkv, dh))
    v = _normal(rng, (b, sk, hkv, dh))
    s_cache = sk - c
    q0 = s_cache - 4 if q0 is None else q0
    qp = np.broadcast_to(q0 + np.arange(c, dtype=np.int32), (b, c)).copy()
    if pad_rows:
        qp[:, c - pad_rows:] = -1
    cache = np.arange(s_cache, dtype=np.int32)
    if ring:                        # a wrapped ring: positions out of order
        cache = (q0 - 1 - ((q0 - 1 - cache) % s_cache)).astype(np.int32)
    filled = s_cache if filled is None else filled
    cache = np.where(np.arange(s_cache) < filled, cache, -1)
    kp = np.concatenate([np.broadcast_to(cache, (b, s_cache)),
                         np.where(qp >= 0, qp, -1)], axis=1).astype(np.int32)
    return q, k, v, qp, kp


CHUNK_CASES = {
    "gqa2": dict(b=2, c=16, sk=48, h=4, hkv=2, dh=16),
    "window": dict(b=2, c=16, sk=48, h=4, hkv=4, dh=16, window=12),
    "softcap": dict(b=1, c=16, sk=40, h=8, hkv=2, dh=16, cap=25.0),
    "ring_empty_rows": dict(b=2, c=8, sk=40, h=4, hkv=2, dh=32, ring=True,
                            filled=25, q0=45),
    "pad_query_rows": dict(b=2, c=13, sk=45, h=4, hkv=2, dh=16, pad_rows=5),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_plain_chunk_attention_matches_reference(case):
    kw = dict(CHUNK_CASES[case])
    win = kw.pop("window", None)
    cap = kw.pop("cap", None)
    q, k, v, qp, kp = _chunk_inputs(8, **kw)
    jq, jk, jv, jqp, jkp = map(jnp.asarray, (q, k, v, qp, kp))
    got = ops.chunk_attention(*map(torch.from_numpy, (q, k, v, qp, kp)),
                              window=win, logit_softcap=cap)
    want = jref.naive_attention(jq, jk, jv, causal=True, window=win,
                                q_positions=jqp, k_positions=jkp,
                                logit_softcap=cap)
    _close(got, want)
    _close(got, jops.chunk_attention(jq, jk, jv, jqp, jkp, window=win,
                                     logit_softcap=cap))
    # the Pallas kernel averages pad query rows over its padded key blocks
    # too: only rows with a live key are held against it
    live = qp[0] >= 0
    pallas = JCA.chunk_attention(jq, jk, jv, jqp, jkp, window=win,
                                 logit_softcap=cap, block_q=8, block_k=16,
                                 interpret=True)
    _close(got[:, live], np.asarray(pallas)[:, live])
    assert np.isfinite(got.numpy()).all()


# ---------------------------------------------------------------------------
# paged_decode_attention
# ---------------------------------------------------------------------------

def _paged_inputs(seed, b, h, hkv, dh, p_sz, n_pp, n_pages):
    """Pools with random K/V, each real page holding consecutive positions
    of one slot, a null page 0 whose position lane holds live-looking
    values (it takes discarded writes), and page maps with unbacked (0)
    entries."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, h, dh))
    k_pool = _normal(rng, (n_pages, p_sz, hkv, dh))
    v_pool = _normal(rng, (n_pages, p_sz, hkv, dh))
    pos_pool = np.full((n_pages, p_sz), -1, np.int32)
    pos_pool[0] = np.arange(p_sz)                 # garbage on the null page
    page_map = np.zeros((b, n_pp), np.int32)
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    t = np.zeros(b, np.int32)
    for s in range(b):
        n_live = 1 + s % n_pp
        for j in range(n_live):
            pid = int(next(ids))
            page_map[s, j] = pid
            pos_pool[pid] = j * p_sz + np.arange(p_sz)
        t[s] = n_live * p_sz - 1 - s        # rows past t: masked by pos <= t
    pos_pool[page_map[0, 0], 1] = -1        # an empty row inside a page
    return q, k_pool, v_pool, pos_pool, page_map, t


PAGED_CASES = {
    "gqa2": dict(b=3, h=4, hkv=2, dh=16, p_sz=4, n_pp=3, n_pages=10),
    "gqa1_window": dict(b=2, h=4, hkv=4, dh=32, p_sz=8, n_pp=4, n_pages=9,
                        window=10),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_plain_paged_decode_attention_matches_reference(case):
    kw = dict(PAGED_CASES[case])
    win = kw.pop("window", None)
    args = _paged_inputs(9, **kw)
    jargs = list(map(jnp.asarray, args))
    got = ops.paged_decode_attention(*map(torch.from_numpy, args),
                                     window=win)
    _close(got, jops.paged_decode_attention(*jargs, window=win))
    pallas = JDA.paged_decode_attention(*jargs, window=win, interpret=True)
    _close(got, pallas)
    # bit-exact against the dense read of the gathered logical rows
    q, k_pool, v_pool, pos_pool, page_map, t = map(torch.from_numpy, args)
    dense = paged_view({"k": k_pool, "v": v_pool, "pos": pos_pool}, page_map)
    assert torch.equal(got, pref.decode_attention(
        q, dense["k"], dense["v"], dense["pos"], t, window=win))


def test_gather_pages_matches_reference():
    pool = _normal(np.random.default_rng(10), (6, 4, 2, 8))
    rows = np.asarray([3, 1, 0, 5], np.int32)
    got = ops.gather_pages(torch.from_numpy(pool), torch.from_numpy(rows))
    want = jops.gather_pages(jnp.asarray(pool), jnp.asarray(rows))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# copy_pages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail", [(), (4,), (2, 3)])
def test_plain_copy_pages_bit_exact(tail):
    """Raw row moves, in place: bit-exact against the reference and the
    Pallas kernel, (0, 0) padding pairs no-ops, untouched rows unchanged."""
    n_pages, p_sz = 7, 8
    pool = _normal(np.random.default_rng(11), (n_pages, p_sz) + tail)
    srcs = np.asarray([1, 3, 0, 0], np.int32)
    dsts = np.asarray([5, 6, 0, 0], np.int32)
    got = torch.from_numpy(pool.copy())
    same = ops.copy_pages(got, torch.from_numpy(srcs), torch.from_numpy(dsts))
    assert same is got                                   # in place
    jp, js, jd = map(jnp.asarray, (pool, srcs, dsts))
    assert np.array_equal(got.numpy(), np.asarray(jops.copy_pages(jp, js,
                                                                  jd)))
    assert np.array_equal(got.numpy(), np.asarray(JPC.copy_pages(
        jp, js, jd, interpret=True)))
    assert np.array_equal(got.numpy()[[0, 1, 2, 3, 4]],
                          pool[[0, 1, 2, 3, 4]])
