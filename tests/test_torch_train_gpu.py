"""The training path's kernels on the card (marker ``gpu``): the
``flash_attention_bwd`` CUDA kernel against its plain version
``ref.flash_attention_bwd`` over qwen3's training, SOI-middle and prefill
shapes, odd sequence lengths, ``q_offset`` > 0 with Sq != Sk (and keys
past the last query), non-causal,
GQA G 1 to 4 and head dims 16/32/64/128 and deepseek-v2's MLA (d_qk 192,
d_v 128), float32 (dq, dk, dv within 2e-5 of each one's largest |value|)
and bfloat16 (2e-2), repeating bit for bit;
the forward's ``lse`` against ``ref.attention_lse``; ``FlashAttentionFn``
through autograd against the plain forward under autograd; the
``lru_scan_bwd`` kernel bit for bit ``ref.lru_scan_bwd`` in float32 (ring
and edge paths, with and without h0), repeating, and ``LruScanFn`` through
autograd; the windowed route differentiated on the card; the grad
refusal of the seven kernels without a backward; the prefix-LM route
(the plain version, differentiated by autograd, no launch); whisper-tiny's
encoder (1500 frames), cross (Sq 128 / Sk 1500) and self shapes and
nemotron-4-15b's G 6 / dh 128; and the serving launch
unchanged: one device kernel a call with grad mode off, no lse.

Without a CUDA device every test here skips (decided inside the ``cuda``
fixture). On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as PFA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

torch.set_num_threads(1)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-3}

# name: (B, Sq, Sk, H, Hkv, dh, q_offset, causal)
BWD_CASES = {
    "train": (8, 128, 128, 16, 8, 128, 0, True),
    "middle": (8, 64, 64, 16, 8, 128, 0, True),
    "prefill": (1, 1024, 1024, 16, 8, 128, 0, True),
    "odd100": (2, 100, 100, 16, 8, 128, 0, True),
    "odd77-dh64": (2, 77, 77, 8, 2, 64, 0, True),
    "dh32-g4": (3, 65, 65, 8, 2, 32, 0, True),
    "dh16-mha": (2, 33, 33, 4, 4, 16, 0, True),
    "offset": (2, 40, 130, 16, 8, 128, 90, True),
    "noncausal": (2, 50, 70, 8, 4, 64, 0, False),
    # a chunk past 0: Sq, Sk and q_offset on no tile edge of either body
    "offset-chunk-dh64": (2, 70, 199, 8, 2, 64, 129, True),
    # keys past the last query: key tiles no row sees get zero dK, dV
    "late-keys": (1, 50, 200, 8, 4, 128, 20, True),
    # deepseek-v2's MLA prefill: (d_qk, d_v) = (192, 128), 128 heads at
    # the training shape and the serving prefill's S 1024; odd and offset
    # rows on no tile edge of either body's key tiles (32 and 64)
    "mla-train": (8, 128, 128, 128, 128, (192, 128), 0, True),
    "mla-prefill": (1, 1024, 1024, 16, 16, (192, 128), 0, True),
    "mla-odd": (2, 77, 77, 4, 4, (192, 128), 0, True),
    "mla-offset-g2": (1, 40, 130, 8, 4, (192, 128), 90, True),
    "mla-noncausal": (2, 33, 50, 4, 4, (192, 128), 0, False),
    # whisper-tiny's training: the encoder over 1500 frames (Sk = 23 x 64 +
    # 28, a ragged last key tile), the cross layers' 128 queries against
    # them, the decoder's causal self attention (G 1, dh 64)
    "whisper-encoder": (8, 1500, 1500, 6, 6, 64, 0, False),
    "whisper-cross": (8, 128, 1500, 6, 6, 64, 0, False),
    "whisper-self": (8, 128, 128, 6, 6, 64, 0, True),
    # nemotron-4-15b: 48 query heads over 8 KV heads (G 6), dh 128
    "nemotron-g6": (2, 128, 128, 48, 8, 128, 0, True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest --noconftest -m gpu "
                    "tests/test_torch_train_gpu.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, dt, dev, seed=0):
    b, sq, sk, h, hkv, dh, off, causal = BWD_CASES[case]
    dqk, dv = dh if isinstance(dh, tuple) else (dh, dh)
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dt)
    return t(b, sq, h, dqk), t(b, sk, hkv, dqk), t(b, sk, hkv, dv), \
        t(b, sq, h, dv), off, causal


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_kernel_matches_plain_and_repeats(cuda, case, dt):
    q, k, v, do, off, causal = _inputs(case, dt, cuda)
    scale = q.shape[-1] ** -0.5
    out, lse = PFA.forward_launch(q, k, v, causal=causal, q_offset=off,
                                  scale=scale, cap=0.0, with_lse=True)
    want_lse = pref.attention_lse(q, k, causal=causal, q_offset=off)
    assert _rel(lse, want_lse) < LSE_TOL[dt]
    assert float((out.float() - pref.flash_attention(
        q, k, v, causal=causal, q_offset=off).float()).abs().max()) \
        < TOL[dt]
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                  q_offset=off)
    again = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                    q_offset=off)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == 2
    want = pref.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                    q_offset=off)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dt and g.shape == w.shape
        assert torch.equal(g, a)
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) < TOL[dt]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["train", "offset", "noncausal",
                                  "mla-odd", "whisper-cross"])
def test_autograd_function_matches_plain_autograd(cuda, case):
    q, k, v, do, off, causal = _inputs(case, torch.float32, cuda, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    o = ops.flash_attention(*leaves, causal=causal, q_offset=off)
    got = torch.autograd.grad(o, leaves, do)
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    po = pref.flash_attention(*plain, causal=causal, q_offset=off)
    want = torch.autograd.grad(po, plain, do)
    assert float((o - po).detach().abs().max()) < TOL[torch.float32]
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL[torch.float32]


@pytest.mark.gpu
def test_backward_refuses_what_it_does_not_take(cuda):
    q, k, v, do, _, _ = _inputs("dh16-mha", torch.float32, cuda)
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(q, k, v, logit_softcap=30.0)
    odd_q = torch.randn(1, 8, 2, 64, device=cuda)
    odd_v = torch.randn(1, 8, 2, 32, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="takes \\(dqk, dv\\)"):
        ops.flash_attention_bwd(odd_q, odd_q, odd_v, odd_v, odd_v, lse)
    qd = q.detach()
    with pytest.raises(ValueError, match="do"):     # do must be (B,Sq,H,dv)
        ops.flash_attention_bwd(qd, k, v, qd, do[:, :-1].contiguous(),
                                lse.new_zeros(2, 4, 33))
    with torch.no_grad():               # serving: the launch without lse
        ops.flash_attention(q, k, v, logit_softcap=30.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_windowed_route_differentiates_on_the_card(cuda, dt):
    """A window takes the plain ref.windowed_flash_attention on every
    device, under grad too: autograd of the plain function, as the
    reference differentiates its plain route; no flash launch."""
    q, k, v, do, _, _ = _inputs("odd77-dh64", dt, cuda, seed=4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    o = ops.flash_attention(*leaves, window=16)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    po = pref.windowed_flash_attention(*plain, window=16)
    want = torch.autograd.grad(po, plain, do)
    assert torch.equal(o, po)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL[dt]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefix_lm_route_is_the_plain_version(cuda, dt):
    """A ``prefix_len > 0`` goes to the plain version on the card too, as
    the reference routes it: its result, no flash launch; with grad,
    autograd of the plain version (the reference differentiates its plain
    route with XLA), no launch of either kernel; the kernel's wrapper
    still raises on a prefix."""
    q, k, v, do, _, _ = _inputs("odd77-dh64", dt, cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, prefix_len=20)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 0
    assert torch.equal(got, pref.flash_attention(q, k, v, prefix_len=20))
    assert not torch.equal(got, ops.flash_attention(q, k, v))
    with pytest.raises(NotImplementedError, match="prefix_len"):
        PFA.flash_attention(q, k, v, prefix_len=20)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    o = ops.flash_attention(*leaves, prefix_len=20)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    po = pref.flash_attention(*plain, prefix_len=20)
    want = torch.autograd.grad(po, plain, do)
    assert torch.equal(o, po)
    for g, w in zip(grads, want):
        assert _rel(g, w) < TOL[dt]


def _calls_without_backward(dev, x):
    """One call of each kernel without a backward, ``x`` (requires grad)
    as its float input."""
    i32 = torch.int32
    q = x[:, 0]                                           # (1, 4, 16)
    kv = torch.randn(1, 8, 2, 16, device=dev)
    pos = torch.arange(8, dtype=i32, device=dev)[None]
    t = torch.tensor([7], dtype=i32, device=dev)
    pools = torch.randn(3, 4, 2, 16, device=dev)
    ppos = torch.arange(12, dtype=i32, device=dev).reshape(3, 4)
    pmap = torch.tensor([[1, 2]], dtype=i32, device=dev)
    lat, rope = torch.randn(1, 8, 16, device=dev), torch.randn(1, 8, 8,
                                                               device=dev)
    return {
        "decode_attention": lambda: ops.decode_attention(q, kv, kv, pos, t),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q, pools, pools, ppos, pmap, t),
        "chunk_attention": lambda: ops.chunk_attention(
            x, kv, kv, pos[:, :2], pos),
        "mla_chunk_attention": lambda: ops.mla_chunk_attention(
            x, x[..., :8].contiguous(), lat, rope, pos[:, :2], pos,
            scale=0.2),
        "paged_mla_decode_attention": lambda: ops.paged_mla_decode_attention(
            q, q[..., :8].contiguous(), lat.reshape(2, 4, 16),
            rope.reshape(2, 4, 8),
            ppos[:2], torch.tensor([[1]], dtype=i32, device=dev), t,
            scale=0.2),
        "stmc_conv": lambda: ops.stmc_conv(x.reshape(2, 4, 16),
                                           torch.randn(4, 16, 8,
                                                       device=dev)),
        "copy_pages": lambda: ops.copy_pages(
            pools.clone().requires_grad_(), [1], [2]),
    }


# the kernels with a backward kernel (and the backwards themselves)
WITH_BACKWARD = ("flash_attention", "flash_attention_bwd", "lru_scan",
                 "lru_scan_bwd")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(
    k.__name__ for k in ops.KERNELS if k.__name__ not in WITH_BACKWARD))
def test_kernels_without_a_backward_refuse_grad(cuda, name):
    x = torch.randn(1, 2, 4, 16, device=cuda, requires_grad=True)
    call = _calls_without_backward(cuda, x)[name]
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="no backward"):
        call()
    assert ops.launch_counts()[name] == 0
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == 1


@pytest.mark.gpu
def test_serving_launch_is_one_kernel_without_lse(cuda):
    """Grad mode off (the engine's): one device kernel a flash call, as
    before the backward existed; with grad on, the forward is still one
    kernel and the bf16 backward two (dQ, which computes delta, then
    dK/dV: no delta pre-pass)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do, _, _ = _inputs("train", torch.bfloat16, cuda, seed=2)
    with torch.no_grad():
        ops.flash_attention(q, k, v)            # built and warm
    torch.cuda.synchronize()

    def kernels(fn):
        # late in a long process a profiler session drops the device
        # records of its first stretch of time (PERF.md §6): spin
        # kernels fill that stretch, and fn's kernels are those after the
        # last spin kernel kept (a session that kept none is taken again
        # with more)
        for n in (32, 128, 512):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    torch.cuda._sleep(400_000)
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
            ev = sorted((e.time_range.start, e.name) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
            marks = [t for t, name in ev if "spin_kernel" in name]
            if marks:
                return [name for t, name in ev if t > marks[-1]]
        raise AssertionError("the profiler kept no spin kernel in three "
                             "sessions")

    with torch.no_grad():
        served = kernels(lambda: ops.flash_attention(q, k, v))
    assert len(served) == 1 and "flash_attention_kernel" in served[0]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd = kernels(lambda: ops.flash_attention(*leaves))
    assert sum("flash_attention_kernel" in n for n in fwd) == 1
    o = ops.flash_attention(*leaves)
    bwd = kernels(lambda: torch.autograd.grad(o, leaves, do))
    names = [n for n in bwd if any(f"::{k}<" in n for k in (
        "delta_kernel", "dkdv_kernel", "dq_kernel"))]
    assert len(names) == 2 and "::dq_kernel<" in names[0] \
        and "::dkdv_kernel<" in names[1]


# lru_scan_bwd cases: (B, S, D, with h0). The training shape of
# recurrentgemma-9b (B 8 x S 128, width 4096), its outer prefill (1, 2040),
# a stage past S's end, S 1, and the edge path (D % 32, a misaligned view)
LRU_CASES = {"train": (8, 128, 4096, False), "prefill": (1, 2040, 4096, True),
             "ragged-stage": (4, 257, 96, True), "s1": (2, 1, 64, True),
             "edge": (3, 37, 100, True), "edge-no-h0": (2, 50, 33, False)}


def _lru_inputs(case, dev, seed=0):
    b, s, d, with_h0 = LRU_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((b, s, d), generator=gen, device=dev) * 0.8 + 0.199
    x = torch.randn((b, s, d), generator=gen, device=dev)
    g = torch.randn((b, s, d), generator=gen, device=dev)
    h0 = (torch.randn((b, d), generator=gen, device=dev) if with_h0
          else None)
    return a, x, g, h0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(LRU_CASES))
def test_lru_scan_bwd_kernel_is_plain_bit_for_bit(cuda, case):
    from repro_torch.kernels import lru_scan as PL
    a, x, g, h0 = _lru_inputs(case, cuda)
    h, _ = ops.lru_scan(a, x, h0)
    plan = PL.lru_plan(*a.shape, torch.float32, streams=3)
    ops.reset_launch_counts()
    got = ops.lru_scan_bwd(a, g, h, h0)
    again = ops.lru_scan_bwd(a, g, h, h0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lru_scan_bwd"] == 2
    assert plan.edge == (a.shape[-1] % 32 != 0)
    want = pref.lru_scan_bwd(a, g, h, h0)
    for name, x_, y, w in zip(("da", "dx", "dh0"), got, again, want):
        if w is None:
            assert x_ is None and y is None
            continue
        assert torch.equal(x_, w), name
        assert torch.equal(x_, y), name


@pytest.mark.gpu
def test_lru_scan_bwd_edge_path_on_a_misaligned_view(cuda):
    """A view 4 bytes past 16-byte alignment takes the edge path, and
    still equals the plain version bit for bit."""
    from repro_torch.kernels import lru_scan as PL
    base = torch.rand(2 * 64 * 128 + 1, device=cuda) * 0.8 + 0.1
    a = base[1:].view(2, 64, 128)
    g = torch.randn(2, 64, 128, device=cuda)
    h = torch.randn(2, 64, 128, device=cuda)
    assert a.data_ptr() % 16 and PL.lru_plan(
        2, 64, 128, torch.float32, streams=3,
        aligned=a.data_ptr() % 16 == 0).edge
    got = ops.lru_scan_bwd(a, g, h)
    want = pref.lru_scan_bwd(a, g, h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged-stage", "edge"])
def test_lru_scan_fn_through_autograd(cuda, case):
    """ops.lru_scan with grad on launches the scan and its backward kernel
    once each; the gradients (h_all's and h_last's cotangents) equal
    ref.lru_scan_bwd's bit for bit and autograd of the plain scan within
    1e-5."""
    a, x, g, h0 = _lru_inputs(case, cuda, seed=1)
    g_last = torch.randn_like(x[:, 0])
    leaves = [t.clone().requires_grad_() for t in (a, x, h0)]
    ops.reset_launch_counts()
    h, last = ops.lru_scan(*leaves)
    got = torch.autograd.grad((h, last), leaves, (g, g_last))
    torch.cuda.synchronize()
    assert ops.launch_counts()["lru_scan"] == 1
    assert ops.launch_counts()["lru_scan_bwd"] == 1
    g_all = g.clone()
    g_all[:, -1] += g_last
    want = pref.lru_scan_bwd(a, g_all, h.detach(), h0)
    for x_, w in zip(got, want):
        assert torch.equal(x_, w)
    plain = [t.clone().requires_grad_() for t in (a, x, h0)]
    ph, plast = pref.lru_scan(*plain)
    auto = torch.autograd.grad((ph, plast), plain, (g, g_last))
    for x_, w in zip(got, auto):
        assert float((x_ - w).abs().max() / w.abs().max()) < 1e-5


@pytest.mark.gpu
def test_lru_scan_grad_refuses_other_dtypes(cuda):
    a, x, g, _ = _lru_inputs("s1", cuda)
    ab = a.to(torch.bfloat16).requires_grad_()
    with pytest.raises(NotImplementedError, match="float32 only"):
        ops.lru_scan(ab, x.to(torch.bfloat16))
    with pytest.raises(NotImplementedError, match="float32 only"):
        ops.lru_scan_bwd(a.to(torch.bfloat16), g, g)
    ops.reset_launch_counts()
    with torch.no_grad():               # serving takes bf16
        ops.lru_scan(ab, x.to(torch.bfloat16))
    assert ops.launch_counts()["lru_scan"] == 1
