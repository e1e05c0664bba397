"""The hand-written CUDA kernels of repro_torch against their plain
PyTorch versions, on the card (marker ``gpu``), at the smoke and the
serving path's shapes: float32 (max|Δ| < 2e-5) and bfloat16 (< 2e-2) for
the attention kernels (GQA and absorbed MLA, flash attention with d_v !=
d_qk too, the decode reads at recurrentgemma's G 16 / dh 256 on a wrapped
windowed ring, where the paged read equals the dense one bit for bit),
``lru_scan`` (bit for bit in float32) and ``stmc_conv`` (at the streaming
U-Net's shapes, with and without bias; float32 results repeat bit for
bit), bit-exact for ``copy_pages``; and a narrow U-Net streamed on the card
against the CPU, with ``stmc_conv`` launched as the phase plans say.

Without a CUDA device every test here skips (decided inside the ``cuda``
fixture, so every worker collects the same tests). On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py manages JAX, which the card's machine
does not have; this file imports no JAX.)
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_attention as PCA
from repro_torch.kernels import decode_attention as PDA
from repro_torch.kernels import flash_attention as PFA
from repro_torch.kernels import lru_scan as PLS
from repro_torch.kernels import page_copy as PPC
from repro_torch.kernels import ref as pref

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _decode_inputs(seed, b, h, hkv, s, dh, *, ring=False, inactive=False):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, h, dh))
    k = _normal(rng, (b, s, hkv, dh))
    v = _normal(rng, (b, s, hkv, dh))
    t = rng.integers(s // 2, s + 4, size=b).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if ring:
        tt = t[:, None] + s // 2
        l = np.arange(s)[None]
        pos = (tt - 1 - ((tt - 1 - l) % s)).astype(np.int32)
        t = (tt[:, 0] - 1).astype(np.int32)
    pos[:, -3:] = -1
    if inactive:
        pos[-1] = -1
    return q, k, v, pos, t


def _flash_inputs(seed, b, sq, sk, h, hkv, dh, dv=None):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, sq, h, dh)), _normal(rng, (b, sk, hkv, dh)),
            _normal(rng, (b, sk, hkv, dv or dh)))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert np.isfinite(got).all() and err < tol, err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_kernels.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


GPU_DECODE = {
    "smoke": dict(b=4, h=4, hkv=2, s=16, dh=16),
    "outer": dict(b=4, h=16, hkv=8, s=1088, dh=128),
    "middle": dict(b=4, h=16, hkv=8, s=768, dh=128),
    "ring_window": dict(b=3, h=8, hkv=8, s=100, dh=64, ring=True, window=40),
    "inactive": dict(b=2, h=16, hkv=2, s=77, dh=32, inactive=True),
    # recurrentgemma's MQA (G 16, dh 256) on a wrapped windowed ring
    "mqa_ring": dict(b=4, h=16, hkv=1, s=2048, dh=256, ring=True,
                     window=2048),
    "mqa_ring_window": dict(b=3, h=16, hkv=1, s=96, dh=256, ring=True,
                            window=40),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_DECODE))
def test_cuda_decode_attention_matches_plain(cuda, case, dtype):
    kw = dict(GPU_DECODE[case])
    win = kw.pop("window", None)
    dt = getattr(torch, dtype)
    q, k, v, pos, t = _decode_inputs(6, **kw)
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in (q, k, v))
    pos, t = torch.from_numpy(pos).to(cuda), torch.from_numpy(t).to(cuda)
    n0 = PDA.decode_attention.launches
    got = PDA.decode_attention(q, k, v, pos, t, window=win)
    torch.cuda.synchronize()
    assert PDA.decode_attention.launches == n0 + 1
    want = pref.decode_attention(q, k, v, pos, t, window=win)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])


GPU_FLASH = {
    "smoke": dict(b=1, sq=16, sk=16, h=4, hkv=2, dh=16),
    "mla_smoke": dict(b=2, sq=40, sk=40, h=4, hkv=4, dh=192, dv=128),
    "mla_prefill": dict(b=1, sq=1024, sk=1024, h=128, hkv=128, dh=192,
                        dv=128),
    "prefill": dict(b=1, sq=1024, sk=1024, h=16, hkv=8, dh=128),
    "middle": dict(b=1, sq=512, sk=512, h=16, hkv=8, dh=128),
    "ragged_offset": dict(b=2, sq=50, sk=120, h=4, hkv=1, dh=64,
                          q_offset=70, cap=30.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_FLASH))
def test_cuda_flash_attention_matches_plain(cuda, case, dtype):
    kw = dict(GPU_FLASH[case])
    qo = kw.pop("q_offset", 0)
    cap = kw.pop("cap", None)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in _flash_inputs(7, **kw))
    n0 = PFA.flash_attention.launches
    got = PFA.flash_attention(q, k, v, q_offset=qo, logit_softcap=cap)
    torch.cuda.synchronize()
    assert PFA.flash_attention.launches == n0 + 1
    want = pref.flash_attention(q, k, v, q_offset=qo, logit_softcap=cap)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    k = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(NotImplementedError):
        PFA.flash_attention(q, k, k, window=4)
    with pytest.raises(NotImplementedError):
        PFA.flash_attention(q, k, k, prefix_len=2)
    with pytest.raises(ValueError, match="contiguous"):
        PFA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, k)
    qd = torch.zeros(2, 4, 16, device=cuda)
    kd = torch.zeros(2, 8, 2, 16, device=cuda)
    pos = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    t = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        PDA.decode_attention(qd, kd, kd, pos, t, logit_softcap=5.0)
    with pytest.raises(TypeError):
        PDA.decode_attention(qd, kd, kd, pos.long(), t)
    pool = torch.zeros(5, 4, 2, 16, device=cuda)
    ppos = torch.zeros(5, 4, dtype=torch.int32, device=cuda)
    pm = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        PDA.paged_decode_attention(qd, pool, pool, ppos, pm, t,
                                   logit_softcap=5.0)
    with pytest.raises(TypeError):
        PDA.paged_decode_attention(qd, pool, pool, ppos, pm.long(), t)
    qc = torch.zeros(1, 4, 4, 16, device=cuda)
    kc = torch.zeros(1, 12, 2, 16, device=cuda)
    qpc = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    kpc = torch.zeros(1, 12, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k_positions"):
        PCA.chunk_attention(qc, kc, kc, qpc, kpc[:, :8])
    with pytest.raises(TypeError):
        PPC.copy_pages(pool, qpc[0, :2].long(), qpc[0, :2].long())
    with pytest.raises(NotImplementedError):         # (dqk, dv) = (16, 8)
        PFA.flash_attention(q, k, k[..., :8].contiguous())
    ql, qr = torch.zeros(1, 4, 4, 24, device=cuda), torch.zeros(
        1, 4, 4, 8, device=cuda)
    lat, rope = torch.zeros(1, 12, 24, device=cuda), torch.zeros(
        1, 12, 8, device=cuda)
    with pytest.raises(NotImplementedError):         # L = 24
        PCA.mla_chunk_attention(ql, qr, lat, rope, qpc, kpc, scale=0.1)
    with pytest.raises(TypeError):
        PCA.mla_chunk_attention(ql[..., :16], qr, lat[..., :16], rope, qpc,
                                kpc, scale=0.1, out_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        PDA.paged_mla_decode_attention(
            ql[:, 0], qr[:, 0], lat.reshape(3, 4, 24), rope.reshape(3, 4, 8),
            kpc.reshape(3, 4), pm[:1], t[:1], scale=0.1)


def _chunk_inputs(seed, b, c, s_cache, h, hkv, dh, *, filled, q0,
                  pad_rows=0):
    """C queries at q0.. (the last ``pad_rows`` at -1) against a ring of
    ``s_cache`` rows (``filled`` of them live, wrapped) plus the chunk."""
    rng = np.random.default_rng(seed)
    sk = s_cache + c
    q = _normal(rng, (b, c, h, dh))
    k = _normal(rng, (b, sk, hkv, dh))
    v = _normal(rng, (b, sk, hkv, dh))
    qp = np.broadcast_to(q0 + np.arange(c, dtype=np.int32), (b, c)).copy()
    if pad_rows:
        qp[:, c - pad_rows:] = -1
    ring = q0 - 1 - ((q0 - 1 - np.arange(s_cache)) % s_cache)
    ring = np.where(np.arange(s_cache) < filled, ring, -1)
    kp = np.concatenate([np.broadcast_to(ring, (b, s_cache)), qp],
                        axis=1).astype(np.int32)
    return q, k, v, qp, kp


GPU_CHUNK = {
    "smoke": dict(b=1, c=4, s_cache=16, h=4, hkv=2, dh=16, filled=8, q0=8),
    "outer": dict(b=1, c=256, s_cache=1088, h=16, hkv=8, dh=128, filled=768,
                  q0=768, pad_rows=40),
    "middle": dict(b=1, c=128, s_cache=768, h=16, hkv=8, dh=128, filled=384,
                   q0=384),
    "ring_window_softcap": dict(b=2, c=50, s_cache=70, h=8, hkv=2, dh=64,
                                filled=70, q0=100, window=30, cap=20.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_CHUNK))
def test_cuda_chunk_attention_matches_plain(cuda, case, dtype):
    kw = dict(GPU_CHUNK[case])
    win = kw.pop("window", None)
    cap = kw.pop("cap", None)
    dt = getattr(torch, dtype)
    q, k, v, qp, kp = _chunk_inputs(8, **kw)
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in (q, k, v))
    qp, kp = torch.from_numpy(qp).to(cuda), torch.from_numpy(kp).to(cuda)
    n0 = PCA.chunk_attention.launches
    got = PCA.chunk_attention(q, k, v, qp, kp, window=win, logit_softcap=cap)
    torch.cuda.synchronize()
    assert PCA.chunk_attention.launches == n0 + 1
    assert bool(torch.isfinite(got).all())        # pad query rows included
    want = pref.chunk_attention(q, k, v, qp, kp, window=win,
                                logit_softcap=cap)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])


def _paged_inputs(seed, b, h, hkv, dh, p_sz, n_pp, t_base):
    """Pools of ``b * n_pp + 1`` pages (page 0 null, with live-looking
    garbage), slot i mapping pages for its positions 0..t_i (the rest of
    its map unbacked), pages handed out in a shuffled order."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_pp + 1
    q = _normal(rng, (b, h, dh))
    k_pool = _normal(rng, (n_pages, p_sz, hkv, dh))
    v_pool = _normal(rng, (n_pages, p_sz, hkv, dh))
    pos_pool = np.full((n_pages, p_sz), -1, np.int32)
    pos_pool[0] = np.arange(p_sz)
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    page_map = np.zeros((b, n_pp), np.int32)
    t = np.asarray([t_base - 3 * i for i in range(b)], np.int32)
    for s in range(b):
        for j in range(t[s] // p_sz + 1):
            pid = int(next(ids))
            page_map[s, j] = pid
            pos_pool[pid] = j * p_sz + np.arange(p_sz)
    return q, k_pool, v_pool, pos_pool, page_map, t


GPU_PAGED = {
    "smoke": dict(b=3, h=4, hkv=2, dh=16, p_sz=4, n_pp=4, t_base=13),
    "outer": dict(b=4, h=16, hkv=8, dh=128, p_sz=16, n_pp=68, t_base=1056),
    "middle": dict(b=4, h=16, hkv=8, dh=128, p_sz=16, n_pp=48, t_base=528),
    "window": dict(b=2, h=8, hkv=2, dh=64, p_sz=16, n_pp=10, t_base=150,
                   window=50),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_PAGED))
def test_cuda_paged_decode_attention_matches_plain(cuda, case, dtype):
    kw = dict(GPU_PAGED[case])
    win = kw.pop("window", None)
    dt = getattr(torch, dtype)
    q, k, v, pos, pm, t = _paged_inputs(9, **kw)
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in (q, k, v))
    pos, pm, t = (torch.from_numpy(x).to(cuda) for x in (pos, pm, t))
    n0 = PDA.paged_decode_attention.launches
    got = PDA.paged_decode_attention(q, k, v, pos, pm, t, window=win)
    torch.cuda.synchronize()
    assert PDA.paged_decode_attention.launches == n0 + 1
    want = pref.paged_decode_attention(q, k, v, pos, pm, t, window=win)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])


GPU_COPY = {
    "kv_bf16": ((273, 16, 8, 128), torch.bfloat16),
    "kv_f32": ((20, 16, 2, 64), torch.float32),
    "pos_i32": ((193, 16), torch.int32),
    "odd_rows": ((9, 3), torch.int32),           # 12-byte rows: byte copy
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_COPY))
def test_cuda_copy_pages_bit_exact(cuda, case):
    shape, dt = GPU_COPY[case]
    g = torch.Generator(device="cpu").manual_seed(10)
    if dt.is_floating_point:
        pool = torch.randn(shape, generator=g).to(dt)
    else:
        pool = torch.randint(-5, 10_000, shape, generator=g, dtype=dt)
    n = shape[0]
    srcs = torch.tensor([1, 3, n - 1, 2, 0, 0], dtype=torch.int32)
    dsts = torch.tensor([n - 2, 5, 4, 2, 0, 0], dtype=torch.int32)
    want = pref.copy_pages(pool.clone(), srcs, dsts)
    dev = pool.to(cuda)
    n0 = PPC.copy_pages.launches
    got = PPC.copy_pages(dev, srcs.to(cuda), dsts.to(cuda))
    torch.cuda.synchronize()
    assert got is dev and PPC.copy_pages.launches == n0 + 1
    assert torch.equal(got.cpu(), want)


def _mla_chunk_inputs(seed, b, c, s_cache, h, lat_d, r, *, filled, q0,
                      pad_rows=0):
    """Absorbed-MLA chunk inputs: C queries at q0.. (the last ``pad_rows``
    at -1) against a ring of ``s_cache`` latent rows (``filled`` of them
    live, wrapped) plus the chunk's own."""
    rng = np.random.default_rng(seed)
    sk = s_cache + c
    ql, qr = _normal(rng, (b, c, h, lat_d)), _normal(rng, (b, c, h, r))
    lat, rope = _normal(rng, (b, sk, lat_d)), _normal(rng, (b, sk, r))
    qp = np.broadcast_to(q0 + np.arange(c, dtype=np.int32), (b, c)).copy()
    if pad_rows:
        qp[:, c - pad_rows:] = -1
    ring = q0 - 1 - ((q0 - 1 - np.arange(s_cache)) % s_cache)
    ring = np.where(np.arange(s_cache) < filled, ring, -1)
    kp = np.concatenate([np.broadcast_to(ring, (b, s_cache)), qp],
                        axis=1).astype(np.int32)
    return ql, qr, lat, rope, qp, kp


GPU_MLA_CHUNK = {
    "smoke": dict(b=2, c=8, s_cache=16, h=4, lat_d=16, r=8, filled=12, q0=12,
                  pad_rows=3),
    "outer": dict(b=1, c=256, s_cache=1088, h=128, lat_d=512, r=64,
                  filled=768, q0=768, pad_rows=6),
    "middle": dict(b=1, c=128, s_cache=768, h=128, lat_d=512, r=64,
                   filled=384, q0=384, pad_rows=3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_MLA_CHUNK))
def test_cuda_mla_chunk_attention_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    ql, qr, lat, rope, qp, kp = _mla_chunk_inputs(11, **GPU_MLA_CHUNK[case])
    ql, qr, lat, rope = (torch.from_numpy(x).to(cuda, dt)
                         for x in (ql, qr, lat, rope))
    qp, kp = torch.from_numpy(qp).to(cuda), torch.from_numpy(kp).to(cuda)
    scale = (128 + 64) ** -0.5
    n0 = PCA.mla_chunk_attention.launches
    got = PCA.mla_chunk_attention(ql, qr, lat, rope, qp, kp, scale=scale)
    torch.cuda.synchronize()
    assert PCA.mla_chunk_attention.launches == n0 + 1
    assert bool(torch.isfinite(got).all())        # pad query rows included
    want = pref.mla_chunk_attention(ql, qr, lat, rope, qp, kp, scale=scale)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])


GPU_PAGED_MLA = {
    "smoke": dict(b=3, h=4, lat_d=16, r=8, p_sz=4, n_pp=4, t_base=13),
    "outer": dict(b=4, h=128, lat_d=512, r=64, p_sz=16, n_pp=68,
                  t_base=1056),
    "middle": dict(b=4, h=128, lat_d=512, r=64, p_sz=16, n_pp=48,
                   t_base=528),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_PAGED_MLA))
def test_cuda_paged_mla_decode_attention_matches_plain(cuda, case, dtype):
    kw = dict(GPU_PAGED_MLA[case])
    lat_d, r = kw.pop("lat_d"), kw.pop("r")
    dt = getattr(torch, dtype)
    # the GQA helper's pools with Hkv = 1: (n_pages, P, 1, L) -> (.., L)
    ql, lat, _, pos, pm, t = _paged_inputs(12, hkv=1, dh=lat_d, **kw)
    rng = np.random.default_rng(13)
    qr = _normal(rng, ql.shape[:2] + (r,))
    rope = _normal(rng, lat.shape[:2] + (r,))
    ql, qr, lat, rope = (torch.from_numpy(x).to(cuda, dt)
                         for x in (ql, qr, lat[:, :, 0], rope))
    pos, pm, t = (torch.from_numpy(x).to(cuda) for x in (pos, pm, t))
    scale = (128 + 64) ** -0.5
    n0 = PDA.paged_mla_decode_attention.launches
    got = PDA.paged_mla_decode_attention(ql, qr, lat, rope, pos, pm, t,
                                         scale=scale)
    torch.cuda.synchronize()
    assert PDA.paged_mla_decode_attention.launches == n0 + 1
    want = pref.paged_mla_decode_attention(ql, qr, lat, rope, pos, pm, t,
                                           scale=scale)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])


def _ring_pools(seed, b, h, hkv, s, dh, p_sz):
    """A wrapped ring (clocks past ``s``) as dense caches, and the same
    logical rows in pools of ``b * s/p_sz + 1`` pages behind shuffled page
    maps (page 0 null, with live-looking garbage)."""
    q, k, v, pos, t = _decode_inputs(seed, b, h, hkv, s, dh, ring=True)
    rng = np.random.default_rng(seed + 1)
    n_pp = s // p_sz
    n_pages = b * n_pp + 1
    k_pool = _normal(rng, (n_pages, p_sz, hkv, dh))
    v_pool = _normal(rng, (n_pages, p_sz, hkv, dh))
    pos_pool = np.full((n_pages, p_sz), -1, np.int32)
    pos_pool[0] = np.arange(p_sz)
    page_map = (1 + rng.permutation(n_pages - 1)).reshape(b, n_pp)
    for i in range(b):
        for j in range(n_pp):
            rows = slice(j * p_sz, (j + 1) * p_sz)
            pid = page_map[i, j]
            k_pool[pid], v_pool[pid] = k[i, rows], v[i, rows]
            pos_pool[pid] = pos[i, rows]
    return (q, k, v, pos, t), (k_pool, v_pool, pos_pool,
                               page_map.astype(np.int32))


GPU_MQA_RING = {
    "serving": dict(b=4, s=2048, p_sz=16, window=2048),
    "window": dict(b=3, s=96, p_sz=16, window=40),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_MQA_RING))
def test_cuda_paged_mqa_ring_equals_dense_kernel(cuda, case, dtype):
    """G 16, dh 256 on a wrapped windowed ring: the paged read matches its
    plain version and equals the dense kernel's read bit for bit."""
    kw = dict(GPU_MQA_RING[case])
    win = kw.pop("window")
    dt = getattr(torch, dtype)
    (q, k, v, pos, t), (kp, vp, pp, pm) = _ring_pools(14, h=16, hkv=1,
                                                      dh=256, **kw)
    q, k, v, kp, vp = (torch.from_numpy(x).to(cuda, dt)
                       for x in (q, k, v, kp, vp))
    pos, t, pp, pm = (torch.from_numpy(x).to(cuda) for x in (pos, t, pp, pm))
    n0 = PDA.paged_decode_attention.launches
    got = PDA.paged_decode_attention(q, kp, vp, pp, pm, t, window=win)
    dense = PDA.decode_attention(q, k, v, pos, t, window=win)
    torch.cuda.synchronize()
    assert PDA.paged_decode_attention.launches == n0 + 1
    want = pref.paged_decode_attention(q, kp, vp, pp, pm, t, window=win)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])
    assert torch.equal(got, dense)


def _lru_inputs(seed, b, s, d, h0=False):
    """Decays in (0.5, 0.999) and inputs scaled by sqrt(1 - a^2), as the
    RG-LRU makes them, so h stays of order 1."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    x = (rng.standard_normal((b, s, d)) * np.sqrt(1 - a * a)).astype(
        np.float32)
    return a, x, (_normal(rng, (b, d)) if h0 else None)


GPU_LRU = {
    "smoke": dict(b=2, s=5, d=64),
    "h0_odd": dict(b=3, s=37, d=100, h0=True),
    "outer": dict(b=1, s=2040, d=4096),
    "middle": dict(b=1, s=1020, d=4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_LRU))
def test_cuda_lru_scan_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    a, x, h0 = _lru_inputs(15, **GPU_LRU[case])
    a, x = (torch.from_numpy(z).to(cuda, dt) for z in (a, x))
    h0 = None if h0 is None else torch.from_numpy(h0).to(cuda)
    n0 = PLS.lru_scan.launches
    got, last = PLS.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert PLS.lru_scan.launches == n0 + 1
    want, want_last = pref.lru_scan(a, x, h0)
    assert got.dtype == dt and torch.equal(last, got[:, -1])
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])
    if dtype == "float32":       # product and sum round as the plain's do
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_lru_scan_refuses_what_the_kernel_does_not_take(cuda):
    a = torch.rand(2, 8, 16, device=cuda)
    with pytest.raises(ValueError):
        PLS.lru_scan(a, a[:, :4])
    with pytest.raises(TypeError):
        PLS.lru_scan(a, a.double())
    with pytest.raises(ValueError, match="contiguous"):
        PLS.lru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="h0"):
        PLS.lru_scan(a, a, torch.zeros(2, 8, device=cuda))


# the STMC conv contraction at the streaming U-Net's shapes (soi-unet-dns:
# decoder 2 at B 1 and B 32, encoder 7 at B 32), a ragged case without bias
# and the small-B tiles; weights at the convs' He-uniform scale
GPU_STMC = {
    "dec2_b1": dict(b=1, k=3, ci=2416, co=664),
    "dec2_b32": dict(b=32, k=3, ci=2416, co=664),
    "enc7_b32": dict(b=32, k=3, ci=1208, co=1296),
    "ragged": dict(b=3, k=3, ci=64, co=129),
    "b2": dict(b=2, k=3, ci=128, co=128),
    "b5_k1": dict(b=5, k=1, ci=40, co=33),
}


def _stmc_inputs(seed, b, k, ci, co):
    rng = np.random.default_rng(seed)
    bound = (6.0 / (k * ci)) ** 0.5
    return (_normal(rng, (b, k, ci)),
            rng.uniform(-bound, bound, (k, ci, co)).astype(np.float32),
            0.1 * _normal(rng, (co,)))


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_STMC))
def test_cuda_stmc_conv_matches_plain(cuda, case, dtype, bias):
    from repro_torch.kernels import stmc_conv as PSC
    dt = getattr(torch, dtype)
    win, w, b = (torch.from_numpy(z).to(cuda, dt)
                 for z in _stmc_inputs(16, **GPU_STMC[case]))
    b = b if bias else None
    n0 = PSC.stmc_conv.launches
    got = PSC.stmc_conv(win, w, b)
    torch.cuda.synchronize()
    assert PSC.stmc_conv.launches == n0 + 1
    want = pref.stmc_conv(win, w, b)
    assert got.dtype == dt and got.shape == want.shape
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])
    # no atomics: a float32 result repeats bit for bit
    assert torch.equal(PSC.stmc_conv(win, w, b), got)


@pytest.mark.gpu
def test_cuda_stmc_conv_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import stmc_conv as PSC
    win = torch.rand(2, 3, 8, device=cuda)
    w = torch.rand(3, 8, 5, device=cuda)
    with pytest.raises(ValueError):
        PSC.stmc_conv(win[0], w)                       # wrong rank
    with pytest.raises(ValueError):
        PSC.stmc_conv(win, w[:, :4])                   # Cin mismatch
    with pytest.raises(ValueError):
        PSC.stmc_conv(win, w, torch.rand(4, device=cuda))
    with pytest.raises(TypeError):
        PSC.stmc_conv(win, w.bfloat16())               # mixed dtypes
    with pytest.raises(TypeError):
        PSC.stmc_conv(win.double(), w.double())        # float64
    with pytest.raises(ValueError, match="contiguous"):
        PSC.stmc_conv(win.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError, match="is on"):
        PSC.stmc_conv(win, w.cpu())                    # another device


@pytest.mark.gpu
@pytest.mark.parametrize("soi", [None, dict(pairs=(1, 3)),
                                 dict(pairs=(2,), mode="fp",
                                      extrapolation="tconv")])
def test_cuda_unet_stream_matches_cpu(cuda, soi):
    """A narrow U-Net streamed on the card (every computed conv through
    stmc_conv, at the count the phase plans give) against the CPU."""
    from repro_torch.core.soi import SOIConvCfg
    from repro_torch.kernels import stmc_conv as PSC
    from repro_torch.models import unet as U
    cfg = U.UNetConfig(in_channels=16, out_channels=16,
                       enc_channels=(24, 32, 40, 48),
                       soi=None if soi is None else SOIConvCfg(**soi))
    model = U.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    x = torch.from_numpy(_normal(np.random.default_rng(2), (3, 12, 16)))
    want = U.stream_infer(model, x, cfg)
    n0 = PSC.stmc_conv.launches
    got = U.stream_infer(model.to(cuda), x.to(cuda), cfg)
    torch.cuda.synchronize()
    per_phase = U.convs_per_phase(cfg)
    assert PSC.stmc_conv.launches - n0 == sum(
        per_phase[t % cfg.period] for t in range(12))
    _close(got.cpu(), want, TOL["float32"])
