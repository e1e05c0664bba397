"""The hand-written CUDA kernels of repro_torch against their plain
PyTorch versions, on the card (marker ``gpu``), at the smoke and the
serving path's shapes: float32 (max|Δ| < 2e-5) and bfloat16 (< 2e-2).

Without a CUDA device every test here skips (decided inside the ``cuda``
fixture, so every worker collects the same tests). On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py manages JAX, which the card's machine
does not have; this file imports no JAX.)
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as PDA
from repro_torch.kernels import flash_attention as PFA
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


def _flash_inputs(seed, b, sq, sk, h, hkv, dh):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, sq, h, dh)), _normal(rng, (b, sk, hkv, dh)),
            _normal(rng, (b, sk, hkv, dh)))


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
