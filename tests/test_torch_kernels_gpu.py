"""The hand-written CUDA kernels of repro_torch against their plain
PyTorch versions, on the card (marker ``gpu``), at the smoke and the
serving path's shapes: float32 (max|Δ| < 2e-5) and bfloat16 (< 2e-2) for
the attention kernels (GQA and absorbed MLA, flash attention with d_v !=
d_qk too, its bf16 tensor-core body on ragged tiles and repeating bit for
bit, whisper's non-causal encoder (Sk 1500) and cross prefill (Sq 64 /
Sk 1500), the decode reads at recurrentgemma's G 16 / dh 256 on a wrapped
windowed ring and at the edges of their split of S, at whisper's cross
read (S 1500, query clock 1 << 30) and at the families' G 6, G 12
(dh 128), dh 80 (G 4, wrapped window rings) and paligemma's G 8 at
dh 256, where the paged read
equals the dense one bit for bit, a (G, dh) no config uses raising, bf16 results repeat bit for bit and stay
within 2^-6 of their largest output, and every split's partial counts
once at its weight; the chunk kernels' bf16 tensor-core bodies over whole
dead key tiles, q tiles of pad rows only, ragged C and Sk, G 1 to 12,
dh 80 on danube's window-4096 serving chunk, and H
no multiple of their 64-head blocks, held to the same 2^-6 and repeating
bit for bit, split or not),
the paged reads over page-map holes and a slot whose map is all null
pages (it sees no key: the plain version's average), the paged MLA read's
bf16 body at ragged H, repeating bit for bit, every range's partial
counted once; ``lru_scan`` (bit for bit in float32, repeating, on both
branches of its plan, the edge path and a misaligned view, and split at
any step equal to the whole scan) and ``stmc_conv`` (at
the streaming U-Net's shapes, B 1 to 40, with and without bias; both
dtypes repeat bit for bit; the masked edge path at Cout 129 and on a
misaligned weight view; one-hot windows count every split of the cluster
once), bit-exact for ``copy_pages`` (and ``copy_pages_leaves``: one launch
over mixed leaves); and a narrow U-Net streamed on the
card against the CPU, with ``stmc_conv`` launched as the phase plans say;
the dense read's ``return_lse`` at qwen3's G 2 and mistral's G 12 (dh
128) over 2 and 4 shards of the ring, a shard that sees no row included:
each shard's out and lse against the plain version's (lse within 1e-4 in
float32, 2e-2 in bf16), and the shards merged against the whole read.

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
# the decode reads in bf16: at most four half-ulps of their largest output
# (an output is a mean of V rows, at recurrentgemma's read ~0.04 RMS)
READ_REL_TOL = 2.0 ** -6


def _read_tol(want, dtype):
    if dtype == "float32":
        return TOL[dtype]
    return min(TOL[dtype], READ_REL_TOL * float(want.float().abs().max()))


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
    # the split's edges (decode_split): S below one range of 64 keys; one
    # key past a range (two ranges, the second of one key); a long cache
    # whose live keys (window 100 behind t) leave the first ranges all
    # masked; an inactive slot at G 16 / dh 256
    "split_short": dict(b=4, h=16, hkv=1, s=40, dh=256),
    "split_plus_one": dict(b=4, h=128, hkv=8, s=65, dh=256),
    "split_masked_head": dict(b=4, h=16, hkv=1, s=2048, dh=256, window=100),
    "split_inactive_mqa": dict(b=3, h=16, hkv=1, s=300, dh=256,
                               inactive=True),
    # the families' shapes: nemotron-4-15b G 6 and mistral-large-123b G 12
    # (8 KV heads of 128; the float32 body keeps 6 heads a block at G 12),
    # h2o-danube-1.8b G 4 at dh 80 (3 dims a lane, the last lane's run
    # stopping at the row's end) on wrapped rings with its window; G 12
    # one key past a range, and an inactive slot at dh 80
    "nemotron_g6": dict(b=4, h=48, hkv=8, s=1024, dh=128),
    "mistral_g12": dict(b=4, h=96, hkv=8, s=1024, dh=128),
    "g12_split_plus_one": dict(b=2, h=24, hkv=2, s=65, dh=128),
    "danube_dh80_ring": dict(b=4, h=32, hkv=8, s=4096, dh=80, ring=True,
                             window=4096),
    "dh80_ring_window": dict(b=3, h=32, hkv=8, s=200, dh=80, ring=True,
                             window=50),
    "dh80_inactive": dict(b=2, h=8, hkv=2, s=77, dh=80, inactive=True),
    # paligemma-3b's MQA read (G 8, dh 256) at the served ring of 1088
    "paligemma_g8": dict(b=4, h=8, hkv=1, s=1088, dh=256),
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
    _close(got.float().cpu(), want.float().cpu(), _read_tol(want, dtype))
    n_split, keys, _ = PDA.launch_plan(q, k)
    if case == "split_short":
        assert (n_split, keys) == (1, 64) and kw["s"] < keys
    elif case == "split_plus_one":
        assert (n_split, kw["s"]) == (2, keys + 1)
    elif case == "split_masked_head":
        assert int(t.min()) - win >= 2 * keys       # ranges 0 and 1 dead


# the sequence-split read's partials (return_lse): qwen3-1.7b's G 2 and
# mistral-large-123b's G 12 at dh 128, the ring's rows over M shards;
# "early" puts slot 0's clock at 100, so the shards past its first see no
# row (out 0, lse -inf)
GPU_LSE = {
    "qwen3_g2": dict(b=4, h=16, hkv=8, s=1088, dh=128),
    "mistral_g12": dict(b=4, h=96, hkv=8, s=1024, dh=128),
    "qwen3_g2_early": dict(b=4, h=16, hkv=8, s=1088, dh=128, t0=100),
}
# lse against the plain version's: float32 scores agree to rounding; the
# bf16 body's scores are bf16 products (PERF.md §6, PR 32)
LSE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_LSE))
def test_cuda_decode_lse_matches_plain_and_merges(cuda, case, dtype, m):
    """Each shard's CUDA (out, lse) against the plain version's, the
    read without the flag unchanged bit for bit, one launch a call, and
    the shards merged in rank order against the unsharded CUDA read."""
    kw = dict(GPU_LSE[case])
    t0 = kw.pop("t0", None)
    dt = getattr(torch, dtype)
    q, k, v, pos, t = _decode_inputs(7, **kw)
    if t0 is not None:
        t[0] = t0
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in (q, k, v))
    pos, t = torch.from_numpy(pos).to(cuda), torch.from_numpy(t).to(cuda)
    rows = kw["s"] // m
    outs, lses = [], []
    for r in range(m):
        sl = slice(r * rows, (r + 1) * rows)
        ks, vs, ps = (x[:, sl].contiguous() for x in (k, v, pos))
        n0 = PDA.decode_attention.launches
        out, lse = PDA.decode_attention(q, ks, vs, ps, t, return_lse=True)
        plain_out = PDA.decode_attention(q, ks, vs, ps, t)
        torch.cuda.synchronize()
        assert PDA.decode_attention.launches == n0 + 2
        w_out, w_lse = pref.decode_attention(q, ks, vs, ps, t,
                                             return_lse=True)
        dead = torch.isneginf(w_lse)
        assert torch.equal(torch.isneginf(lse), dead)
        assert not torch.isnan(lse).any() and not torch.isnan(out).any()
        assert not out[dead].any()
        live = ~dead
        if live.any():
            _close(lse[live].cpu(), w_lse[live].cpu(), LSE_TOL[dtype])
            _close(out[live].float().cpu(), w_out[live].float().cpu(),
                   _read_tol(w_out[live], dtype))
        assert torch.equal(out[live], plain_out[live])
        outs.append(out)
        lses.append(lse)
    if t0 is not None:
        assert torch.isneginf(lses[-1][0]).all()
    merged = pref.merge_partials(torch.stack(outs), torch.stack(lses))
    whole = PDA.decode_attention(q, k, v, pos, t)
    _close(merged.float().cpu(), whole.float().cpu(),
           _read_tol(whole, dtype))


GPU_REPEAT = {
    "outer": dict(b=4, h=16, hkv=8, s=1088, dh=128, p_sz=16),
    "mqa_ring": dict(b=4, h=16, hkv=1, s=2048, dh=256, p_sz=16, window=2048),
    "split_plus_one": dict(b=4, h=128, hkv=8, s=65, dh=256, p_sz=1),
    "mistral_g12": dict(b=4, h=96, hkv=8, s=1024, dh=128, p_sz=16),
    "danube_dh80": dict(b=4, h=32, hkv=8, s=4096, dh=80, p_sz=16,
                        window=4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_REPEAT))
def test_cuda_decode_reads_bf16_repeat_bit_for_bit(cuda, case):
    """The split and the combine add in a fixed order (no atomics): a
    second launch on the same inputs gives the same bits, dense and
    paged."""
    kw = dict(GPU_REPEAT[case])
    win = kw.pop("window", None)
    (q, k, v, pos, t), (kp, vp, pp, pm) = _ring_pools(6, **kw)
    q, k, v, kp, vp = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                       for x in (q, k, v, kp, vp))
    pos, t, pp, pm = (torch.from_numpy(x).to(cuda) for x in (pos, t, pp, pm))
    dense = PDA.decode_attention(q, k, v, pos, t, window=win)
    paged = PDA.paged_decode_attention(q, kp, vp, pp, pm, t, window=win)
    assert torch.equal(dense, PDA.decode_attention(q, k, v, pos, t,
                                                   window=win))
    assert torch.equal(paged, PDA.paged_decode_attention(q, kp, vp, pp, pm,
                                                         t, window=win))


GPU_FLASH = {
    "smoke": dict(b=1, sq=16, sk=16, h=4, hkv=2, dh=16),
    "mla_smoke": dict(b=2, sq=40, sk=40, h=4, hkv=4, dh=192, dv=128),
    "mla_prefill": dict(b=1, sq=1024, sk=1024, h=128, hkv=128, dh=192,
                        dv=128),
    "prefill": dict(b=1, sq=1024, sk=1024, h=16, hkv=8, dh=128),
    "middle": dict(b=1, sq=512, sk=512, h=16, hkv=8, dh=128),
    "ragged_offset": dict(b=2, sq=50, sk=120, h=4, hkv=1, dh=64,
                          q_offset=70, cap=30.0),
    # the bf16 body's tiling: 64 query rows a block and 64-key tiles up
    # to d_qk 128, 128 rows and 32-key tiles at 192
    "mla_ragged": dict(b=2, sq=77, sk=77, h=4, hkv=4, dh=192, dv=128),
    "tile_plus_one": dict(b=1, sq=65, sk=65, h=4, hkv=2, dh=128),
    "gqa4": dict(b=1, sq=200, sk=200, h=16, hkv=4, dh=128),
    "gqa8": dict(b=1, sq=200, sk=200, h=16, hkv=2, dh=128),
    "offset_dh128": dict(b=2, sq=100, sk=260, h=8, hkv=2, dh=128,
                         q_offset=160),
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,dv", [(128, 128), (192, 128)])
def test_cuda_flash_attention_bidirectional_matches_plain(cuda, dh, dv,
                                                          dtype):
    """causal=False: every key tile is walked, the last one ragged."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in _flash_inputs(9, 1, 70, 150, 4, 2, dh, dv))
    got = PFA.flash_attention(q, k, v, causal=False)
    want = pref.flash_attention(q, k, v, causal=False)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])


# whisper-tiny's non-causal shapes: the encoder over 1500 frames (the last
# key tile ragged: 1500 = 23 * 64 + 28) and a decoder prompt's cross read
# of them, 6 heads of 64; at B 2 to hold the batch stride too
GPU_FLASH_WHISPER = {
    "encoder": dict(b=2, sq=1500, sk=1500, h=6, hkv=6, dh=64),
    "cross": dict(b=2, sq=64, sk=1500, h=6, hkv=6, dh=64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_FLASH_WHISPER))
def test_cuda_flash_attention_whisper_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in _flash_inputs(10, **GPU_FLASH_WHISPER[case]))
    n0 = PFA.flash_attention.launches
    got = PFA.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert PFA.flash_attention.launches == n0 + 1
    want = pref.flash_attention(q, k, v, causal=False)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])
    if dtype == "bfloat16":
        assert torch.equal(got, PFA.flash_attention(q, k, v, causal=False))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 4])
def test_cuda_cross_read_matches_plain(cuda, b, dtype):
    """whisper's cross read: 1500 encoder rows at positions 0..1499 from a
    query at 1 << 30 (every row visible), G 1 / dh 64. The split of S
    leaves a ragged last range; the read matches its plain version,
    repeats bit for bit, and equals the softmax over all 1500 rows."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    s = 1500
    q, k, v = (torch.from_numpy(_normal(rng, shape)).to(cuda, dt)
               for shape in ((b, 6, 64), (b, s, 6, 64), (b, s, 6, 64)))
    pos = torch.arange(s, dtype=torch.int32, device=cuda)[None].repeat(b, 1)
    t = torch.full((b,), 1 << 30, dtype=torch.int32, device=cuda)
    n_split, keys, _ = PDA.launch_plan(q, k)
    assert n_split * keys >= s > (n_split - 1) * keys
    got = PDA.decode_attention(q, k, v, pos, t)
    want = pref.decode_attention(q, k, v, pos, t)
    _close(got.float().cpu(), want.float().cpu(), _read_tol(want, dtype))
    full = torch.softmax(torch.einsum("bhd,bshd->bhs", q.float(), k.float())
                         * 64 ** -0.5, -1)
    sdpa = torch.einsum("bhs,bshd->bhd", full, v.float())
    _close(got.float().cpu(), sdpa.cpu(), _read_tol(want, dtype))
    if dtype == "bfloat16":
        assert torch.equal(got, PDA.decode_attention(q, k, v, pos, t))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["prefill", "mla_ragged", "gqa8",
                                  "offset_dh128", "ragged_offset"])
def test_cuda_flash_attention_bf16_repeats_bit_for_bit(cuda, case):
    """The tensor-core body adds in a fixed order (no atomics): two
    launches on the same inputs give the same bits."""
    kw = dict(GPU_FLASH[case])
    qo = kw.pop("q_offset", 0)
    cap = kw.pop("cap", None)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _flash_inputs(8, **kw))
    first = PFA.flash_attention(q, k, v, q_offset=qo, logit_softcap=cap)
    second = PFA.flash_attention(q, k, v, q_offset=qo, logit_softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,dh", [(3, 128), (6, 64), (12, 256), (2, 80),
                                  (8, 80)])
def test_cuda_reads_refuse_shapes_not_instantiated(cuda, g, dh, dtype):
    """A (G, dh) no config uses is not built: the CUDA decode reads raise
    NotImplementedError on it (no plain fallback, no launch counted), as
    the chunk kernel does on a head width it is not built for."""
    dt = getattr(torch, dtype)
    q = torch.zeros(2, 2 * g, dh, device=cuda, dtype=dt)
    k = torch.zeros(2, 8, 2, dh, device=cuda, dtype=dt)
    pos = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    t = torch.zeros(2, dtype=torch.int32, device=cuda)
    pool = torch.zeros(5, 4, 2, dh, device=cuda, dtype=dt)
    ppos = torch.zeros(5, 4, dtype=torch.int32, device=cuda)
    pm = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    n0 = (PDA.decode_attention.launches,
          PDA.paged_decode_attention.launches)
    with pytest.raises(NotImplementedError, match="G in"):
        PDA.decode_attention(q, k, k, pos, t)
    with pytest.raises(NotImplementedError, match="G in"):
        PDA.paged_decode_attention(q, pool, pool, ppos, pm, t)
    assert (PDA.decode_attention.launches,
            PDA.paged_decode_attention.launches) == n0
    qc = torch.zeros(1, 4, 4, 96, device=cuda, dtype=dt)
    kc = torch.zeros(1, 12, 2, 96, device=cuda, dtype=dt)
    qpc = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    kpc = torch.zeros(1, 12, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="dh in"):
        PCA.chunk_attention(qc, kc, kc, qpc, kpc)


def _offset_view(shape, dtype, device):
    """A contiguous tensor whose data starts one element (2 bytes in bf16)
    past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype, device=device)[1:].view(shape)


@pytest.mark.gpu
def test_cuda_chunk_kernels_reject_misaligned_bf16(cuda):
    """The bf16 bodies copy 16 bytes at a time: a base pointer off a
    16-byte boundary raises before any launch (none counted)."""
    bf = torch.bfloat16
    q = _offset_view((1, 4, 4, 64), bf, cuda)
    k = torch.zeros(1, 12, 2, 64, dtype=bf, device=cuda)
    qp = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    kp = torch.zeros(1, 12, dtype=torch.int32, device=cuda)
    n0 = PCA.chunk_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        PCA.chunk_attention(q, k, k, qp, kp)
    ql = _offset_view((1, 4, 4, 512), bf, cuda)
    qr = torch.zeros(1, 4, 4, 64, dtype=bf, device=cuda)
    lat = torch.zeros(1, 12, 512, dtype=bf, device=cuda)
    rope = torch.zeros(1, 12, 64, dtype=bf, device=cuda)
    m0 = PCA.mla_chunk_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        PCA.mla_chunk_attention(ql, qr, lat, rope, qp, kp, scale=0.1)
    assert PCA.chunk_attention.launches == n0
    assert PCA.mla_chunk_attention.launches == m0


def _ring(q0, s_cache, filled, holes):
    """Positions of a ring of ``s_cache`` rows before position ``q0``:
    the first ``filled`` rows live (wrapped), the rest empty, and every
    ``holes``-th row empty too."""
    ring = q0 - 1 - ((q0 - 1 - np.arange(s_cache)) % s_cache)
    ring = np.where(np.arange(s_cache) < filled, ring, -1)
    if holes:
        ring[::holes] = -1
    return ring


def _chunk_inputs(seed, b, c, s_cache, h, hkv, dh, *, filled, q0,
                  pad_rows=0, holes=0, key_shift=0):
    """C queries at q0.. (the last ``pad_rows`` at -1) against a ring of
    ``s_cache`` rows (``_ring``) plus the chunk, every key position moved
    ``key_shift`` later (so early queries may see no key)."""
    rng = np.random.default_rng(seed)
    sk = s_cache + c
    q = _normal(rng, (b, c, h, dh))
    k = _normal(rng, (b, sk, hkv, dh))
    v = _normal(rng, (b, sk, hkv, dh))
    qp = np.broadcast_to(q0 + np.arange(c, dtype=np.int32), (b, c)).copy()
    if pad_rows:
        qp[:, c - pad_rows:] = -1
    ring = _ring(q0, s_cache, filled, holes)
    kp = np.concatenate([np.broadcast_to(ring, (b, s_cache)), qp],
                        axis=1).astype(np.int32)
    kp = np.where(kp >= 0, kp + key_shift, -1).astype(np.int32)
    return q, k, v, qp, kp


GPU_CHUNK = {
    "smoke": dict(b=1, c=4, s_cache=16, h=4, hkv=2, dh=16, filled=8, q0=8),
    "outer": dict(b=1, c=256, s_cache=1088, h=16, hkv=8, dh=128, filled=768,
                  q0=768, pad_rows=40),
    "middle": dict(b=1, c=128, s_cache=768, h=16, hkv=8, dh=128, filled=384,
                   q0=384),
    "ring_window_softcap": dict(b=2, c=50, s_cache=70, h=8, hkv=2, dh=64,
                                filled=70, q0=100, window=30, cap=20.0),
    # whole dead key tiles: an empty stretch of 256 ring rows, and every
    # third row empty besides
    "dead_stretch_holes": dict(b=2, c=70, s_cache=600, h=8, hkv=4, dh=64,
                               filled=344, q0=500, holes=3),
    # a q tile of pad rows only (flat rows 64..99 at G 1): the walk again
    "pad_q_tile": dict(b=1, c=100, s_cache=200, h=4, hkv=4, dh=64,
                       filled=150, q0=150, pad_rows=40),
    # C and Sk no multiples of the tiles
    "ragged": dict(b=2, c=37, s_cache=91, h=8, hkv=4, dh=32, filled=70,
                   q0=80, pad_rows=3),
    "ragged_window": dict(b=1, c=65, s_cache=130, h=4, hkv=2, dh=16,
                          filled=110, q0=200, pad_rows=7, window=41),
    # queries at real positions that see no key (the first 16: every key
    # lies after them), in blocks whose other rows do: the walk again
    "late_keys": dict(b=1, c=48, s_cache=64, h=4, hkv=2, dh=64, filled=64,
                      q0=100, key_shift=80),
    **{f"g{g}_dh{dh}": dict(b=1, c=96, s_cache=300, h=8, hkv=8 // g, dh=dh,
                            filled=250, q0=260, pad_rows=4)
       for g in (1, 2, 4, 8) for dh in (64, 128)},
    # h2o-danube-1.8b: its serving chunk at dh 80 over a full window-4096
    # ring (pad queries at -1), and ragged C and Sk at dh 80; G 6 and G 12
    # at dh 128 (G is a runtime value of the kernel)
    "danube_dh80": dict(b=1, c=256, s_cache=4096, h=32, hkv=8, dh=80,
                        filled=4096, q0=4096, pad_rows=40, window=4096),
    "dh80_ragged_window": dict(b=2, c=37, s_cache=91, h=8, hkv=2, dh=80,
                               filled=70, q0=80, pad_rows=3, window=30),
    "g6_dh128": dict(b=1, c=64, s_cache=200, h=48, hkv=8, dh=128,
                     filled=150, q0=160, pad_rows=5),
    "g12_dh128": dict(b=1, c=64, s_cache=200, h=96, hkv=8, dh=128,
                      filled=150, q0=160, pad_rows=5),
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
    _close(got.float().cpu(), want.float().cpu(), _read_tol(want, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("split", ["plan", "one_range"])
def test_cuda_chunk_attention_bf16_repeats_bit_for_bit(cuda, split):
    """The serving chunk, pad rows included, over the wrapper's split of
    the keys and over one range: a second launch gives the same bits (no
    atomics; the merge adds in split order), and the two plans agree
    within the bf16 bound."""
    q, k, v, qp, kp = _chunk_inputs(8, **GPU_CHUNK["outer"])
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in (q, k, v))
    qp, kp = torch.from_numpy(qp).to(cuda), torch.from_numpy(kp).to(cuda)
    plan = PCA.launch_plan(q, k)
    assert plan[0] > 1                 # the serving chunk is split
    if split == "one_range":
        plan = (1, plan[1] * plan[0], None)
    first = PCA._run_plan(q, k, v, qp, kp, plan)
    again = PCA._run_plan(q, k, v, qp, kp, plan)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    want = pref.chunk_attention(q, k, v, qp, kp)
    _close(first.float().cpu(), want.float().cpu(),
           _read_tol(want, "bfloat16"))


@pytest.mark.gpu
@pytest.mark.parametrize("case,again", [
    ("middle", False),                  # the serving middle chunk: no pad
    ("dead_stretch_holes", False),
    ("pad_q_tile", True),               # a q tile of pad rows only
    ("late_keys", True)])               # real rows that see no key
def test_cuda_chunk_walk_counted_on_the_card(cuda, case, again):
    """The bf16 body's own counts: each block reports the tiles of its
    range, skips whole dead tiles, and walks its range again (all of it)
    only where a row sees no key in all of Sk; the counted launch gives
    the wrapper's bits."""
    kw = dict(GPU_CHUNK[case])
    q, k, v, qp, kp = _chunk_inputs(8, **kw)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in (q, k, v))
    qp, kp = torch.from_numpy(qp).to(cuda), torch.from_numpy(kp).to(cuda)
    n0 = PCA.chunk_attention.launches
    out, walk = PCA.chunk_walk(q, k, v, qp, kp)
    assert PCA.chunk_attention.launches == n0
    assert torch.equal(out, PCA.chunk_attention(q, k, v, qp, kp))
    n_split, keys, _ = PCA.launch_plan(q, k)
    sk = k.shape[1]
    tiles = torch.tensor([-(-(min(sk, (i + 1) * keys) - i * keys)
                            // PCA.KEY_TILE) for i in range(n_split)])
    w = walk.cpu().view(n_split, -1, 3)    # (split, row block, counts)
    assert torch.equal(w[..., 0], tiles[:, None].expand_as(w[..., 0]))
    assert int(w[..., 1].sum()) > 0
    assert bool((w[..., 1] <= w[..., 0]).all())
    assert bool(((w[..., 2] == 0) | (w[..., 2] == w[..., 0])).all())
    assert bool((w[..., 2] > 0).any()) == again


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


def _unmap(page_map, holes=False, null_slot=False):
    """Holes: slot 0's map entries 1 and 3 set to the null page (its rows
    there unbacked); null_slot: the last slot's whole map null, so it sees
    no key and the read averages the null page's rows, as the plain
    version's gathered view holds them."""
    page_map = page_map.copy()
    if holes:
        page_map[0, [1, 3]] = 0
    if null_slot:
        page_map[-1] = 0
    return page_map


GPU_PAGED = {
    "smoke": dict(b=3, h=4, hkv=2, dh=16, p_sz=4, n_pp=4, t_base=13),
    "outer": dict(b=4, h=16, hkv=8, dh=128, p_sz=16, n_pp=68, t_base=1056),
    "middle": dict(b=4, h=16, hkv=8, dh=128, p_sz=16, n_pp=48, t_base=528),
    "window": dict(b=2, h=8, hkv=2, dh=64, p_sz=16, n_pp=10, t_base=150,
                   window=50),
    "holes_null_slot": dict(b=3, h=16, hkv=8, dh=128, p_sz=16, n_pp=20,
                            t_base=300, holes=True, null_slot=True),
    # the families' shapes: G 6, G 12 at dh 128 and dh 80 with a window
    "nemotron_g6": dict(b=4, h=48, hkv=8, dh=128, p_sz=16, n_pp=64,
                        t_base=1000),
    "mistral_g12": dict(b=4, h=96, hkv=8, dh=128, p_sz=16, n_pp=64,
                        t_base=1000),
    "dh80_window_holes": dict(b=3, h=32, hkv=8, dh=80, p_sz=16, n_pp=12,
                              t_base=180, window=50, holes=True,
                              null_slot=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_PAGED))
def test_cuda_paged_decode_attention_matches_plain(cuda, case, dtype):
    kw = dict(GPU_PAGED[case])
    win = kw.pop("window", None)
    unmap = dict(holes=kw.pop("holes", False),
                 null_slot=kw.pop("null_slot", False))
    dt = getattr(torch, dtype)
    q, k, v, pos, pm, t = _paged_inputs(9, **kw)
    pm = _unmap(pm, **unmap)
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in (q, k, v))
    pos, pm, t = (torch.from_numpy(x).to(cuda) for x in (pos, pm, t))
    n0 = PDA.paged_decode_attention.launches
    got = PDA.paged_decode_attention(q, k, v, pos, pm, t, window=win)
    torch.cuda.synchronize()
    assert PDA.paged_decode_attention.launches == n0 + 1
    want = pref.paged_decode_attention(q, k, v, pos, pm, t, window=win)
    _close(got.float().cpu(), want.float().cpu(), _read_tol(want, dtype))


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


def _misaligned(shape, dtype, cuda, g):
    """A contiguous pool whose first byte sits one element past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    flat = torch.randint(-5, 10_000, (n + 1,), generator=g, dtype=torch.int32)
    return flat.to(dtype).to(cuda)[1:].view(shape)


@pytest.mark.gpu
def test_cuda_copy_pages_leaves_one_launch_over_mixed_leaves(cuda):
    """One launch for a flush over qwen3's K/V and pos leaves, MLA latent and
    rope leaves, 12-byte rows and a misaligned pool (byte copies), each
    leaf with its own pair list (none, padding pairs, ids past its pages)
    — bit for bit the plain version leaf by leaf."""
    g = torch.Generator(device="cpu").manual_seed(12)
    pools = [torch.randn((273, 16, 8, 128), generator=g).to(torch.bfloat16),
             torch.randint(-1, 2048, (273, 16), generator=g,
                           dtype=torch.int32),
             torch.randn((50, 16, 512), generator=g).to(torch.bfloat16),
             torch.randn((50, 16, 64), generator=g).to(torch.bfloat16),
             torch.randint(0, 99, (9, 3), generator=g, dtype=torch.int32)]
    srcs = [[5, 17, 100, 201, 0, 0, 0, 0], [5, 17, 100, 201, 0, 0, 0, 0],
            [3, 7, 0], [3, 7, 0], [1, 2]]
    dsts = [[250, 260, 270, 272, 0, 0, 0, 0], [250, 260, 270, 272, 0, 0, 0, 0],
            [40, 49, 0], [40, 49, 0], [8, 9]]        # 9: past the pages
    want = [pref.copy_pages(p.clone(), torch.tensor(s), torch.tensor(d))
            for p, s, d in zip(pools[:-1], srcs, dsts)]
    want.append(pools[-1].clone())
    want[-1][8] = pools[-1][1]                    # (2, 9) is skipped
    dev = [p.to(cuda) for p in pools]
    odd = _misaligned((20, 16, 8), torch.float32, cuda, g)
    dev.append(odd)
    srcs.append([2, 3, 4])
    dsts.append([10, 11, 4])
    want.append(pref.copy_pages(odd.cpu().clone(), torch.tensor(srcs[-1]),
                                torch.tensor(dsts[-1])))
    dev.append(torch.zeros(4, 16, device=cuda))
    srcs.append([])
    dsts.append([])
    want.append(torch.zeros(4, 16))
    n0 = PPC.copy_pages.launches
    assert odd.data_ptr() % 16 and PPC.copy_pages_leaves(dev, srcs,
                                                         dsts) is dev
    torch.cuda.synchronize()
    assert PPC.copy_pages.launches == n0 + 1
    for i, (got, w) in enumerate(zip(dev, want)):
        assert torch.equal(got.cpu(), w), i


def _mla_chunk_inputs(seed, b, c, s_cache, h, lat_d, r, *, filled, q0,
                      pad_rows=0, holes=0, key_shift=0):
    """Absorbed-MLA chunk inputs: C queries at q0.. (the last ``pad_rows``
    at -1) against a ring of ``s_cache`` latent rows (``_ring``) plus the
    chunk's own, every key position moved ``key_shift`` later."""
    rng = np.random.default_rng(seed)
    sk = s_cache + c
    ql, qr = _normal(rng, (b, c, h, lat_d)), _normal(rng, (b, c, h, r))
    lat, rope = _normal(rng, (b, sk, lat_d)), _normal(rng, (b, sk, r))
    qp = np.broadcast_to(q0 + np.arange(c, dtype=np.int32), (b, c)).copy()
    if pad_rows:
        qp[:, c - pad_rows:] = -1
    ring = _ring(q0, s_cache, filled, holes)
    kp = np.concatenate([np.broadcast_to(ring, (b, s_cache)), qp],
                        axis=1).astype(np.int32)
    kp = np.where(kp >= 0, kp + key_shift, -1).astype(np.int32)
    return ql, qr, lat, rope, qp, kp


GPU_MLA_CHUNK = {
    "smoke": dict(b=2, c=8, s_cache=16, h=4, lat_d=16, r=8, filled=12, q0=12,
                  pad_rows=3),
    "outer": dict(b=1, c=256, s_cache=1088, h=128, lat_d=512, r=64,
                  filled=768, q0=768, pad_rows=6),
    "middle": dict(b=1, c=128, s_cache=768, h=128, lat_d=512, r=64,
                   filled=384, q0=384, pad_rows=3),
    # whole dead 32-key tiles (an empty stretch of 128 rows and every
    # fifth row empty), ragged C and Sk, pad queries
    "dead_stretch_holes": dict(b=2, c=45, s_cache=300, h=128, lat_d=512,
                               r=64, filled=172, q0=400, pad_rows=4,
                               holes=5),
    # H no multiple of the block's 64 heads, B 2
    "h4_b2": dict(b=2, c=20, s_cache=70, h=4, lat_d=512, r=64, filled=50,
                  q0=60, pad_rows=2),
    "h72_b2": dict(b=2, c=24, s_cache=100, h=72, lat_d=512, r=64, filled=80,
                   q0=90, pad_rows=3),
    # real query positions that see no key (the first 16): the walk again
    "late_keys": dict(b=1, c=24, s_cache=64, h=16, lat_d=512, r=64,
                      filled=64, q0=100, key_shift=80),
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
    _close(got.float().cpu(), want.float().cpu(), _read_tol(want, dtype))


@pytest.mark.gpu
def test_cuda_mla_chunk_attention_bf16_repeats_bit_for_bit(cuda):
    ql, qr, lat, rope, qp, kp = _mla_chunk_inputs(
        11, **GPU_MLA_CHUNK["outer"])
    ql, qr, lat, rope = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                         for x in (ql, qr, lat, rope))
    qp, kp = torch.from_numpy(qp).to(cuda), torch.from_numpy(kp).to(cuda)
    scale = (128 + 64) ** -0.5
    first = PCA.mla_chunk_attention(ql, qr, lat, rope, qp, kp, scale=scale)
    again = PCA.mla_chunk_attention(ql, qr, lat, rope, qp, kp, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
@pytest.mark.parametrize("case,again", [("middle", False),
                                        ("dead_stretch_holes", False),
                                        ("late_keys", True)])
def test_cuda_mla_chunk_walk_counted_on_the_card(cuda, case, again):
    """The bf16 MLA body's own counts: a block (heads of one query) skips
    whole dead tiles, a pad query's block none, and only a query that
    sees no key walks every tile again; the counted launch gives the
    wrapper's bits."""
    kw = GPU_MLA_CHUNK[case]
    ql, qr, lat, rope, qp, kp = _mla_chunk_inputs(11, **kw)
    ql, qr, lat, rope = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                         for x in (ql, qr, lat, rope))
    qp, kp = torch.from_numpy(qp).to(cuda), torch.from_numpy(kp).to(cuda)
    scale = (128 + 64) ** -0.5
    m0 = PCA.mla_chunk_attention.launches
    out, walk = PCA.mla_chunk_walk(ql, qr, lat, rope, qp, kp, scale=scale)
    assert PCA.mla_chunk_attention.launches == m0
    assert torch.equal(out, PCA.mla_chunk_attention(ql, qr, lat, rope, qp,
                                                     kp, scale=scale))
    b, c = qp.shape
    # blocks (b, y, x) hold query c - 1 - y: flip to query order
    w = walk.cpu().view(b, c, -1, 3).flip(1)
    assert bool((w[..., 0] == -(-lat.shape[1] // 32)).all())
    assert int(w[..., 1].sum()) > 0
    assert int(w[qp.cpu() < 0][..., 1].sum()) == 0
    assert bool(((w[..., 2] == 0) | (w[..., 2] == w[..., 0])).all())
    assert bool((w[..., 2] > 0).any()) == again


GPU_PAGED_MLA = {
    "smoke": dict(b=3, h=4, lat_d=16, r=8, p_sz=4, n_pp=4, t_base=13),
    "outer": dict(b=4, h=128, lat_d=512, r=64, p_sz=16, n_pp=68,
                  t_base=1056),
    "middle": dict(b=4, h=128, lat_d=512, r=64, p_sz=16, n_pp=48,
                   t_base=528),
    # heads past a 64-head block (bf16) masked; pages of one slot unbacked
    # mid-map; a slot whose whole map is null (it sees no key), at the
    # serving widths and the test widths
    "h72": dict(b=2, h=72, lat_d=512, r=64, p_sz=16, n_pp=10, t_base=150),
    "holes_null_slot": dict(b=3, h=128, lat_d=512, r=64, p_sz=16, n_pp=20,
                            t_base=300, holes=True, null_slot=True),
    "smoke_null_slot": dict(b=3, h=4, lat_d=16, r=8, p_sz=4, n_pp=4,
                            t_base=13, null_slot=True),
}


def _paged_mla_inputs(cuda, dt, seed, lat_d, r, holes=False, null_slot=False,
                      **kw):
    """The GQA helper's pools with Hkv = 1 ((n_pages, P, 1, L) -> (.., L))
    and rope pools beside them, on the card in ``dt``."""
    ql, lat, _, pos, pm, t = _paged_inputs(seed, hkv=1, dh=lat_d, **kw)
    pm = _unmap(pm, holes, null_slot)
    rng = np.random.default_rng(seed + 1)
    qr = _normal(rng, ql.shape[:2] + (r,))
    rope = _normal(rng, lat.shape[:2] + (r,))
    ql, qr, lat, rope = (torch.from_numpy(x).to(cuda, dt)
                         for x in (ql, qr, lat[:, :, 0], rope))
    pos, pm, t = (torch.from_numpy(x).to(cuda) for x in (pos, pm, t))
    return ql, qr, lat, rope, pos, pm, t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_PAGED_MLA))
def test_cuda_paged_mla_decode_attention_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    args = _paged_mla_inputs(cuda, dt, 12, **GPU_PAGED_MLA[case])
    scale = (128 + 64) ** -0.5
    n0 = PDA.paged_mla_decode_attention.launches
    got = PDA.paged_mla_decode_attention(*args, scale=scale)
    torch.cuda.synchronize()
    assert PDA.paged_mla_decode_attention.launches == n0 + 1
    want = pref.paged_mla_decode_attention(*args, scale=scale)
    _close(got.float().cpu(), want.float().cpu(), _read_tol(want, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["outer", "h72", "holes_null_slot"])
def test_cuda_paged_mla_bf16_repeats_bit_for_bit(cuda, case):
    """The ranges' partials and the combine add in a fixed order (no
    atomics): a second launch on the same inputs gives the same bits."""
    args = _paged_mla_inputs(cuda, torch.bfloat16, 12, **GPU_PAGED_MLA[case])
    scale = (128 + 64) ** -0.5
    first = PDA.paged_mla_decode_attention(*args, scale=scale)
    again = PDA.paged_mla_decode_attention(*args, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_cuda_paged_mla_counts_every_split_once(cuda):
    """q = 0: every live key scores alike, so the read is the latent's mean
    over the live keys. Latent row s holds n_split in the column of its
    range and 0 elsewhere, so output column j is n_split times range j's
    share of the live keys: a partial that the combine drops, adds twice
    or weighs wrongly moves its column by that whole share."""
    kw = dict(GPU_PAGED_MLA["outer"])
    ql, qr, lat, rope, pos, pm, t = _paged_mla_inputs(cuda, torch.bfloat16,
                                                      12, **kw)
    n_split, keys, _ = PDA.paged_mla_launch_plan(ql, qr, pos, pm)
    assert 1 < n_split <= lat.shape[-1]
    p_sz = kw["p_sz"]
    rows = torch.arange(pm.shape[1] * p_sz, device=cuda)
    pages = pm[:, rows // p_sz].long()
    lat = torch.zeros_like(lat)
    lat[pages, (rows % p_sz).expand_as(pages),
        (rows // keys).expand_as(pages)] = n_split
    ql, qr = torch.zeros_like(ql), torch.zeros_like(qr)
    scale = (128 + 64) ** -0.5
    got = PDA.paged_mla_decode_attention(ql, qr, lat, rope, pos, pm, t,
                                         scale=scale).float()
    want = pref.paged_mla_decode_attention(ql, qr, lat, rope, pos, pm, t,
                                           scale=scale).float()
    totals = want[..., :n_split].sum(-1)
    assert torch.allclose(totals, torch.full_like(totals, n_split),
                          rtol=1e-2)
    _close(got.cpu(), want.cpu(), _read_tol(want, "bfloat16"))


def _ring_pools(seed, b, h, hkv, s, dh, p_sz, inactive=False):
    """A wrapped ring (clocks past ``s``) as dense caches, and the same
    logical rows in pools of ``b * s/p_sz + 1`` pages behind shuffled page
    maps (page 0 null, with live-looking garbage)."""
    q, k, v, pos, t = _decode_inputs(seed, b, h, hkv, s, dh, ring=True,
                                     inactive=inactive)
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


MQA = dict(h=16, hkv=1, dh=256)
GPU_MQA_RING = {
    "serving": dict(b=4, s=2048, p_sz=16, window=2048, **MQA),
    "window": dict(b=3, s=96, p_sz=16, window=40, **MQA),
    # pages of 1 and 4 rows; an inactive slot (all positions -1, every page
    # mapped); qwen3's G 2 / dh 128 serving ring
    "page1": dict(b=2, s=130, p_sz=1, window=50, **MQA),
    "page4": dict(b=3, s=200, p_sz=4, window=None, **MQA),
    "inactive": dict(b=3, s=320, p_sz=16, window=None, inactive=True, **MQA),
    "qwen3_gqa2": dict(b=4, s=1088, p_sz=16, window=None, h=16, hkv=8,
                       dh=128),
    # the families' shapes on wrapped rings: danube's window-4096 serving
    # ring at dh 80, G 6 at pages of 4 and G 12 at pages of 1
    "danube_dh80": dict(b=4, s=4096, p_sz=16, window=4096, h=32, hkv=8,
                        dh=80),
    "g6_page4": dict(b=3, s=200, p_sz=4, window=None, h=12, hkv=2, dh=128),
    "g12_page1": dict(b=2, s=130, p_sz=1, window=50, h=24, hkv=2, dh=128),
    # paligemma-3b's G 8 / dh 256 at its served ring and at pages of 4
    "paligemma_g8": dict(b=4, s=1088, p_sz=16, window=None, h=8, hkv=1,
                         dh=256),
    "g8_page4": dict(b=3, s=200, p_sz=4, window=None, h=8, hkv=1, dh=256),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_MQA_RING))
def test_cuda_paged_mqa_ring_equals_dense_kernel(cuda, case, dtype):
    """G 16, dh 256 (and qwen3's G 2, dh 128) on a wrapped ring: the paged
    read matches its plain version and equals the dense kernel's read bit
    for bit, whatever the page size."""
    kw = dict(GPU_MQA_RING[case])
    win = kw.pop("window")
    dt = getattr(torch, dtype)
    (q, k, v, pos, t), (kp, vp, pp, pm) = _ring_pools(14, **kw)
    q, k, v, kp, vp = (torch.from_numpy(x).to(cuda, dt)
                       for x in (q, k, v, kp, vp))
    pos, t, pp, pm = (torch.from_numpy(x).to(cuda) for x in (pos, t, pp, pm))
    n0 = PDA.paged_decode_attention.launches
    got = PDA.paged_decode_attention(q, kp, vp, pp, pm, t, window=win)
    dense = PDA.decode_attention(q, k, v, pos, t, window=win)
    torch.cuda.synchronize()
    assert PDA.paged_decode_attention.launches == n0 + 1
    want = pref.paged_decode_attention(q, kp, vp, pp, pm, t, window=win)
    _close(got.float().cpu(), want.float().cpu(), _read_tol(want, dtype))
    assert torch.equal(got, dense)


GPU_COVERAGE = {
    "mqa_serving": dict(b=4, s=2048, p_sz=16, window=2048, **MQA),
    "mqa_masked_head": dict(b=3, s=1024, p_sz=16, window=100, **MQA),
    "qwen3_gqa2": dict(b=4, s=1088, p_sz=16, window=None, h=16, hkv=8,
                       dh=128),
    "mistral_g12": dict(b=4, s=1024, p_sz=16, window=None, h=96, hkv=8,
                        dh=128),
    "danube_dh80": dict(b=4, s=4096, p_sz=16, window=4096, h=32, hkv=8,
                        dh=80),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_COVERAGE))
def test_cuda_decode_reads_count_every_split_once(cuda, case, dtype):
    """With q = 0 every live key scores alike, so a read is V's mean over
    its live keys. V row s holds n_split in the column of its split and 0
    elsewhere, so output column j is n_split times split j's share of the
    live keys: a partial that the combine drops, adds twice or weighs
    wrongly moves its column by that whole share, dense and paged."""
    kw = dict(GPU_COVERAGE[case])
    win = kw.pop("window")
    b, s, p_sz = kw["b"], kw["s"], kw["p_sz"]
    (q, k, v, pos, t), (kp, vp, pp, pm) = _ring_pools(21, **kw)
    n_split, keys = PDA.decode_split(b, s, kw["hkv"])
    assert 1 < n_split <= kw["dh"]
    rows = np.arange(s)
    v = np.zeros_like(v)
    v[:, rows, :, rows // keys] = n_split
    for i in range(b):
        for j in range(s // p_sz):
            vp[pm[i, j]] = v[i, j * p_sz:(j + 1) * p_sz]
    dt = getattr(torch, dtype)
    q, k, v, kp, vp = (torch.from_numpy(x).to(cuda, dt)
                       for x in (np.zeros_like(q), k, v, kp, vp))
    pos, t, pp, pm = (torch.from_numpy(x).to(cuda) for x in (pos, t, pp, pm))
    dense = PDA.decode_attention(q, k, v, pos, t, window=win)
    paged = PDA.paged_decode_attention(q, kp, vp, pp, pm, t, window=win)
    want = pref.decode_attention(q, k, v, pos, t, window=win).float()
    # the columns of the splits hold all the mass (float32: no rounding)
    totals = pref.decode_attention(q.float(), k.float(), v.float(), pos, t,
                                   window=win)[..., :n_split].sum(-1)
    assert torch.allclose(totals, torch.full_like(totals, n_split),
                          rtol=1e-5)
    _close(dense.float().cpu(), want.cpu(), _read_tol(want, dtype))
    assert torch.equal(paged, dense)


def _lru_inputs(seed, b, s, d, h0=False):
    """Decays in (0.5, 0.999) and inputs scaled by sqrt(1 - a^2), as the
    RG-LRU makes them, so h stays of order 1."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    x = (rng.standard_normal((b, s, d)) * np.sqrt(1 - a * a)).astype(
        np.float32)
    return a, x, (_normal(rng, (b, d)) if h0 else None)


# (inputs, the plan's branch: chain-warps a block, or the edge path)
GPU_LRU = {
    "smoke": (dict(b=2, s=5, d=64), 1),
    "h0_odd": (dict(b=3, s=37, d=100, h0=True), "edge"),
    "odd_wide": (dict(b=1, s=300, d=4095), "edge"),
    "outer": (dict(b=1, s=2040, d=4096), 1),
    "middle": (dict(b=1, s=1020, d=4096), 1),
    "b4_ragged_stage": (dict(b=4, s=257, d=4096, h0=True), 4),
    "b64_short": (dict(b=64, s=7, d=4096), 8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_LRU))
def test_cuda_lru_scan_matches_plain(cuda, case, dtype):
    """Both branches of the plan (one chain-warp a block, several) and the
    edge path: float32 bit for bit, both dtypes repeating bit for bit."""
    kw, branch = GPU_LRU[case]
    dt = getattr(torch, dtype)
    a, x, h0 = _lru_inputs(15, **kw)
    a, x = (torch.from_numpy(z).to(cuda, dt) for z in (a, x))
    h0 = None if h0 is None else torch.from_numpy(h0).to(cuda)
    plan = PLS.launch_plan(a, x)
    assert (plan.edge if branch == "edge" else
            (not plan.edge and plan.warps == branch)), plan
    n0 = PLS.lru_scan.launches
    got, last = PLS.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert PLS.lru_scan.launches == n0 + 1
    want, want_last = pref.lru_scan(a, x, h0)
    assert got.dtype == dt and torch.equal(last, got[:, -1])
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])
    if dtype == "float32":       # product and sum round as the plain's do
        assert torch.equal(got, want)
    assert torch.equal(PLS.lru_scan(a, x, h0)[0], got)


@pytest.mark.gpu
def test_cuda_lru_scan_misaligned_view_takes_the_edge_path(cuda):
    """Contiguous a and x one element past a 16-byte boundary: the edge
    path, bit for bit the plain version in float32."""
    a, x, _ = _lru_inputs(16, 2, 70, 128)
    n = a.size
    bufs = [torch.zeros(n + 1, device=cuda) for _ in range(2)]
    for buf, z in zip(bufs, (a, x)):
        buf[1:] = torch.from_numpy(z).reshape(-1).to(cuda)
    a, x = (buf[1:].view(2, 70, 128) for buf in bufs)
    assert PLS.launch_plan(a, x).edge and not PLS.lru_plan(2, 70, 128,
                                                            torch.float32).edge
    got, _ = PLS.lru_scan(a, x)
    assert torch.equal(got, pref.lru_scan(a, x)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 64, 100, 299])
def test_cuda_lru_scan_is_chunk_invariant(cuda, k):
    """A scan of [0, S) equals a scan of [0, k), then of [k, S) from its
    last state, bit for bit in float32: at a stage's edge (64) and inside
    one, on the ring path (B 2, D 4096) and the edge path (D 100)."""
    for d in (4096, 100):
        a, x, h0 = _lru_inputs(17, 2, 300, d, h0=True)
        a, x, h0 = (torch.from_numpy(z).to(cuda) for z in (a, x, h0))
        whole, last = PLS.lru_scan(a, x, h0)
        head, mid = PLS.lru_scan(a[:, :k].contiguous(), x[:, :k].contiguous(),
                                 h0)
        tail, tail_last = PLS.lru_scan(a[:, k:].contiguous(),
                                       x[:, k:].contiguous(), mid)
        assert torch.equal(whole, torch.cat([head, tail], 1)), d
        assert torch.equal(last, tail_last), d


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
# decoder 2 at B 1 and B 32, encoder 7 at B 32, decoder 7 (Cout 128, the
# narrowest column tile) and encoder 1 (the shortest splits) at B 1), a
# ragged case without bias (Cout 129: the masked edge path) and the small-B
# tiles, B 20 (rows of the 32-row tile past B) and B 40 (two row tiles), an
# odd K*Cin; weights at the convs' He-uniform scale
GPU_STMC = {
    "dec2_b1": dict(b=1, k=3, ci=2416, co=664),
    "dec2_b32": dict(b=32, k=3, ci=2416, co=664),
    "enc7_b32": dict(b=32, k=3, ci=1208, co=1296),
    "dec7_b1": dict(b=1, k=3, ci=1232, co=128),
    "enc1_b1": dict(b=1, k=3, ci=128, co=616),
    "ragged": dict(b=3, k=3, ci=64, co=129),
    "b2": dict(b=2, k=3, ci=128, co=128),
    "b5_k1": dict(b=5, k=1, ci=40, co=33),
    "b20": dict(b=20, k=3, ci=300, co=200),
    "b40": dict(b=40, k=1, ci=70, co=36),
    # odd K*Cin: bf16 window pairs off 4-byte boundaries, loaded one by one
    "odd_kc": dict(b=2, k=3, ci=37, co=40),
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
    # no atomics: a result repeats bit for bit
    assert torch.equal(PSC.stmc_conv(win, w, b), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_stmc_conv_edge_path(cuda, dtype):
    """The 16-byte loads need whole 16-byte groups in every weight row and
    an aligned pointer: Cout 129 and a weight view one element past a
    16-byte boundary take the masked element-by-element path of the same
    kernel, and match the plain version."""
    from repro_torch.kernels import stmc_conv as PSC
    dt = getattr(torch, dtype)
    assert not PSC.stmc_plan(3, 192, 129, dt).vec16
    assert PSC.stmc_plan(3, 192, 128, dt).vec16
    win, w, b = (torch.from_numpy(z).to(cuda, dt)
                 for z in _stmc_inputs(17, b=3, k=3, ci=64, co=128))
    w_off = _offset_view(tuple(w.shape), dt, cuda)
    w_off.copy_(w)
    assert w_off.data_ptr() % 16 and w_off.is_contiguous()
    got = PSC.stmc_conv(win, w_off, b)
    want = pref.stmc_conv(win, w, b)
    _close(got.float().cpu(), want.float().cpu(), TOL[dtype])
    assert torch.equal(got, PSC.stmc_conv(win, w, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dec2_b1", "dec7_b1", "ragged"])
def test_cuda_stmc_conv_counts_every_split_once(cuda, case, dtype):
    """One-hot windows: row i of B holds a single 1 at contraction row k_i
    in split i of the cluster (its first row for even i, its last for odd
    i), so y[i] is exactly weight row k_i plus the bias — a split whose
    partial the cluster drops or adds twice gives 0 or twice that row."""
    from repro_torch.kernels import stmc_conv as PSC
    kw = GPU_STMC[case]
    k, ci, co = kw["k"], kw["ci"], kw["co"]
    dt = getattr(torch, dtype)
    kc = k * ci
    plan = PSC.stmc_plan(1, kc, co, dt)
    assert plan.splits > 1
    hot = [i * plan.keys_per_split if i % 2 == 0
           else min(kc, (i + 1) * plan.keys_per_split) - 1
           for i in range(plan.splits)]
    _, w, b = (torch.from_numpy(z).to(cuda, dt)
               for z in _stmc_inputs(18, b=1, k=k, ci=ci, co=co))
    win = torch.zeros((plan.splits, kc), dtype=dt, device=cuda)
    win[torch.arange(plan.splits), torch.tensor(hot)] = 1
    win = win.view(plan.splits, k, ci)
    flat = w.view(kc, co)
    assert torch.equal(PSC.stmc_conv(win, w), flat[hot])
    got = PSC.stmc_conv(win, w, b)
    assert torch.equal(got, pref.stmc_conv(win, w, b))


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
