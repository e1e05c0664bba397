"""repro_torch.kernels.costs and the cost meter against the reference's
pricing:

  * the port's closed forms equal ``repro.kernels.costs.price`` for all
    nine kernel names, on the same shapes;
  * each closed form equals the meter's count of the kernel's plain
    version at a small shape, where the plain version does the reference's
    work (lru_scan's is elementwise; the backward's plain version also
    recomputes the scores, a term the test names);
  * ``flash_attention_bwd``'s price is what the reference's HLO parser
    charges ``jax.grad`` of ``ref.chunked_flash_attention`` beyond its
    forward, so a training step's forward + backward is charged what the
    reference charges the gradient;
  * every kernel of ``ops.KERNELS`` is metered and registered; a kernel
    called with no registry entry fails the meter;
  * the meter's conventions: 2·M·N·K a product, a sort n·log2(n), ops
    inside a kernel call left out, an indexing op billed for what it moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo as ref_hlo
from repro.kernels import costs as ref_costs
from repro.kernels import ref as jref
from repro_torch.analysis import cost, meter
from repro_torch.kernels import costs, ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

_BYTES = {"f32": 4, "bf16": 2, "s32": 4}

# operand (dtype, dims) lists in the reference's operand order, and the
# result, for each kernel name
SHAPES = {
    "flash_attention": ([("f32", (2, 16, 4, 32)), ("f32", (2, 16, 2, 32)),
                         ("f32", (2, 16, 2, 32))], ("f32", (2, 16, 4, 32))),
    "chunk_attention": ([("bf16", (1, 8, 4, 16)), ("bf16", (1, 40, 2, 16)),
                         ("bf16", (1, 40, 2, 16)), ("s32", (1, 8)),
                         ("s32", (1, 40))], ("bf16", (1, 8, 4, 16))),
    "mla_chunk_attention": ([("f32", (1, 8, 4, 32)), ("f32", (1, 8, 4, 8)),
                             ("f32", (1, 24, 32)), ("f32", (1, 24, 8)),
                             ("s32", (1, 8)), ("s32", (1, 24))],
                            ("f32", (1, 8, 4, 32))),
    "decode_attention": ([("f32", (3, 4, 16)), ("f32", (3, 20, 2, 16)),
                          ("f32", (3, 20, 2, 16)), ("s32", (3, 20)),
                          ("s32", (3,))], ("f32", (3, 4, 16))),
    "paged_decode_attention": ([("s32", (3, 5)), ("f32", (3, 4, 16)),
                                ("f32", (9, 4, 2, 16)),
                                ("f32", (9, 4, 2, 16)), ("s32", (9, 4)),
                                ("s32", (3,))], ("f32", (3, 4, 16))),
    "paged_mla_decode_attention": ([("s32", (2, 3)), ("bf16", (2, 4, 32)),
                                    ("bf16", (2, 4, 8)),
                                    ("bf16", (7, 4, 32)),
                                    ("bf16", (7, 4, 8)), ("s32", (7, 4)),
                                    ("s32", (2,))], ("bf16", (2, 4, 32))),
    "copy_pages": ([("s32", (2, 3)), ("f32", (9, 4, 2, 16))],
                   ("f32", (9, 4, 2, 16))),
    "lru_scan": ([("f32", (2, 12, 8)), ("f32", (2, 12, 8)),
                  ("f32", (2, 8))], ("f32", (2, 12, 8))),
    "stmc_conv": ([("f32", (2, 96)), ("f32", (96, 32)), ("f32", (32,))],
                  ("f32", (2, 32))),
}


def _shape(mod, dtype, dims):
    return mod.Shape(dtype, tuple(dims), int(np.prod(dims)) * _BYTES[dtype])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_price_equals_reference(name):
    ops_, out = SHAPES[name]
    mine = costs.price(name, _shape(costs, *out),
                       [_shape(costs, *o) for o in ops_])
    theirs = ref_costs.price(name, _shape(ref_costs, *out),
                             [_shape(ref_costs, *o) for o in ops_])
    assert mine == theirs and mine["bytes"] > 0


def test_registry_names():
    """The reference's nine names, plus the two backwards no TPU kernel
    has;
    every kernel of ops.KERNELS is registered and metered (copy_pages
    through its launch point, copy_pages_leaves)."""
    assert set(costs.KERNEL_COSTS) == set(ref_costs.KERNEL_COSTS) | {
        "flash_attention_bwd", "lru_scan_bwd"}
    from repro_torch.kernels.page_copy import copy_pages_leaves
    for k in ops.KERNELS:
        assert k.__name__ in costs.KERNEL_COSTS
        assert hasattr(k if k is not ops.copy_pages else copy_pages_leaves,
                       "__wrapped__"), k.__name__


def _rng_tensor(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _plain_cases(rng):
    """(name, plain fn, wrapper, args, kwargs) at small shapes."""
    b, s, h, hkv, dh = 2, 12, 4, 2, 16
    q = _rng_tensor(rng, (b, h, dh))
    kc = _rng_tensor(rng, (b, s, hkv, dh))
    vc = _rng_tensor(rng, (b, s, hkv, dh))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    t = torch.full((b,), s - 1, dtype=torch.int32)
    qf = _rng_tensor(rng, (b, 10, h, dh))
    kf = _rng_tensor(rng, (b, 10, hkv, dh))
    vf = _rng_tensor(rng, (b, 10, hkv, dh))
    qc = _rng_tensor(rng, (1, 4, h, dh))
    kk = _rng_tensor(rng, (1, 12, hkv, dh))
    vk = _rng_tensor(rng, (1, 12, hkv, dh))
    qp = torch.arange(8, 12, dtype=torch.int32)[None]
    kp = torch.arange(12, dtype=torch.int32)[None]
    n_pages, p_sz = 7, 4
    kpool = _rng_tensor(rng, (n_pages, p_sz, hkv, dh))
    vpool = _rng_tensor(rng, (n_pages, p_sz, hkv, dh))
    ppool = torch.arange(n_pages * p_sz, dtype=torch.int32).view(n_pages,
                                                                 p_sz)
    pmap = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    tq = torch.full((b,), 30, dtype=torch.int32)
    lat, r = 32, 8
    ql = _rng_tensor(rng, (1, 4, h, lat))
    qr = _rng_tensor(rng, (1, 4, h, r))
    latent = _rng_tensor(rng, (1, 12, lat))
    rope = _rng_tensor(rng, (1, 12, r))
    qdl = _rng_tensor(rng, (b, h, lat))
    qdr = _rng_tensor(rng, (b, h, r))
    lpool = _rng_tensor(rng, (n_pages, p_sz, lat))
    rpool = _rng_tensor(rng, (n_pages, p_sz, r))
    win = _rng_tensor(rng, (3, 3, 16))
    w = _rng_tensor(rng, (3, 16, 24))
    bias = _rng_tensor(rng, (24,))
    pool = _rng_tensor(rng, (n_pages, p_sz, hkv, dh))
    return [
        ("decode_attention", tref.decode_attention, ops.decode_attention,
         (q, kc, vc, pos, t), {}),
        ("flash_attention", tref.flash_attention, ops.flash_attention,
         (qf, kf, vf), {}),
        ("chunk_attention", tref.chunk_attention, ops.chunk_attention,
         (qc, kk, vk, qp, kp), {}),
        ("paged_decode_attention", tref.paged_decode_attention,
         ops.paged_decode_attention, (q, kpool, vpool, ppool, pmap, tq), {}),
        ("mla_chunk_attention", tref.mla_chunk_attention,
         ops.mla_chunk_attention, (ql, qr, latent, rope, qp, kp),
         {"scale": 0.1}),
        ("paged_mla_decode_attention", tref.paged_mla_decode_attention,
         ops.paged_mla_decode_attention,
         (qdl, qdr, lpool, rpool, ppool, pmap, tq), {"scale": 0.1}),
        ("stmc_conv", tref.stmc_conv, ops.stmc_conv, (win, w, bias), {}),
        ("copy_pages", lambda p, s_, d_: tref.copy_pages(
            p, torch.tensor(s_), torch.tensor(d_)), ops.copy_pages,
         (pool.clone(), [1, 2], [5, 6]), {}),
    ]


@pytest.mark.parametrize("idx", range(8))
def test_price_equals_plain_version_count(idx):
    """The wrapper on the CPU is charged its closed form, with the plain
    version's own ops left out; that closed form equals what the meter
    counts when the plain version is called directly, with its own
    products (copy_pages: 0 FLOPs, a data movement)."""
    name, plain, wrapper, args, kw = _plain_cases(
        np.random.default_rng(idx))[idx]
    _, plain_m = meter.measure(plain, *args, **kw)
    _, kern_m = meter.measure(wrapper, *args, **kw)
    assert dict(kern_m.kernels) == {name: 1}
    assert kern_m.flops == plain_m.flops
    assert kern_m.by_op[name] == kern_m.flops


def test_lru_scan_priced_in_closed_form():
    """lru_scan's work is elementwise (h = a*h + x): the meter, like the
    reference's parser, counts no product in its plain version, and the
    closed form charges 2 FLOPs an element."""
    rng = np.random.default_rng(1)
    a = _rng_tensor(rng, (2, 12, 8)).sigmoid()
    x = _rng_tensor(rng, (2, 12, 8))
    _, plain_m = meter.measure(tref.lru_scan, a, x)
    _, kern_m = meter.measure(ops.lru_scan, a, x)
    assert plain_m.flops == 0
    assert kern_m.flops == 2.0 * a.numel()


def test_lru_scan_bwd_priced_in_closed_form():
    """lru_scan_bwd's work is elementwise too: c = a*c + g and da =
    c*h_prev, 3 FLOPs an element; its bytes are a, g, h (and h0) read and
    da, dx (and dh0) written once."""
    rng = np.random.default_rng(2)
    a = _rng_tensor(rng, (2, 12, 8)).sigmoid()
    g, h = _rng_tensor(rng, (2, 12, 8)), _rng_tensor(rng, (2, 12, 8))
    h0 = _rng_tensor(rng, (2, 8))
    _, plain_m = meter.measure(tref.lru_scan_bwd, a, g, h, h0)
    _, kern_m = meter.measure(ops.lru_scan_bwd, a, g, h, h0)
    assert plain_m.flops == 0
    assert dict(kern_m.kernels) == {"lru_scan_bwd": 1}
    assert kern_m.flops == 3.0 * a.numel()
    assert kern_m.bytes == 4 * (5 * a.numel() + 2 * h0.numel())
    _, m = meter.measure(ops.lru_scan_bwd, a, g, h)
    assert m.bytes == 4 * 5 * a.numel()


BWD_SHAPES = [(1, 64, 64, 2, 2, 32, 32, True), (2, 32, 32, 4, 2, 16, 16,
                                                  True),
              (1, 16, 48, 2, 1, 32, 32, False), (1, 32, 32, 2, 2, 24, 16,
                                                  True),
              # deepseek-v2's MLA prefill: d_qk 192, d_v 128
              (1, 8, 8, 2, 2, 192, 128, True)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_price_is_the_reference_gradient(shape):
    """price(flash_attention) + price(flash_attention_bwd) equals
    ``hlo.flops_of`` of ``jax.grad`` of ``ref.chunked_flash_attention``,
    and the backward alone the gradient's FLOPs beyond the forward's. One
    named term: at dv != dqk (MLA) the reference's own registry formula
    for the forward, 4·q_elems·Sk, differs from the dots its parser
    counts, 2·Sk·(q_elems + o_elems), by 2·Sk·(q_elems − o_elems); the
    port copies the registry. The port's plain backward recomputes the
    scores (one more product, 2·Sk·q_elems) where the kernel reads the
    forward's log-sum-exp."""
    b, sq, sk, h, hkv, dh, dv, causal = shape
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, h, dh), (b, sk, hkv, dh), (b, sk, hkv, dv), (b, sq, h, dv)))

    def fwd(q, k, v):
        return jref.chunked_flash_attention(q, k, v, causal=causal)

    def grad(q, k, v, do):
        return jax.grad(lambda q, k, v: jnp.sum(fwd(q, k, v) * do),
                        argnums=(0, 1, 2))(q, k, v)

    ref_fwd = ref_hlo.flops_of(fwd, q, k, v)
    ref_grad = ref_hlo.flops_of(grad, q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = tref.flash_attention(tq, tk, tv, causal=causal)
    lse = tref.attention_lse(tq, tk, causal=causal)
    _, fm = meter.measure(ops.flash_attention, tq, tk, tv, causal=causal)
    _, bm = meter.measure(ops.flash_attention_bwd, tq, tk, tv, o, tdo, lse,
                          causal=causal)
    term = 2.0 * sk * (tq.numel() - o.numel())
    assert (term == 0) == (dh == dv)
    assert fm.flops == ref_fwd + term
    assert bm.flops == ref_grad - ref_fwd
    assert fm.flops + bm.flops == ref_grad + term
    _, plain = meter.measure(tref.flash_attention_bwd, tq, tk, tv, o, tdo,
                             lse, causal=causal)
    assert plain.flops == bm.flops + 2.0 * sk * tq.numel()


def test_unpriced_kernel_fails_the_meter(monkeypatch):
    """A kernel called with no registry entry is reported, and the cost
    pass refuses the measurement."""
    case = _plain_cases(np.random.default_rng(0))[0]
    monkeypatch.delitem(costs.KERNEL_COSTS, "decode_attention")
    _, m = meter.measure(case[2], *case[3])
    assert m.unpriced_kernels == ["decode_attention"]
    assert m.flops == 0                 # nothing of the plain version leaks
    with pytest.raises(ValueError, match="decode_attention"):
        cost.require_priced("cell.generate", m)


def test_meter_conventions():
    """2·M·N·K a product; a sort n·log2(n) as the reference's parser bills
    an HLO sort (the MoE dispatch's argsort); an embedding lookup billed
    twice its output, not the table; a cache write twice its update; a
    view nothing; no meter, no hook."""
    a, b = torch.ones(8, 16), torch.ones(16, 32)
    _, m = meter.measure(torch.matmul, a, b)
    assert m.flops == 2 * 8 * 16 * 32
    _, m = meter.measure(torch.argsort, torch.tensor([[3, 1], [0, 2]]),
                         dim=-1, stable=True)
    assert m.flops == 4 * 2.0
    table = torch.ones(1000, 64)
    _, m = meter.measure(torch.nn.functional.embedding,
                         torch.tensor([1, 2]), table)
    assert m.bytes == 2 * 2 * 64 * 4
    cache = torch.zeros(100, 64)
    _, m = meter.measure(cache.index_put_, (torch.tensor([3]),),
                         torch.ones(1, 64))
    assert m.bytes == 2 * 64 * 4
    _, m = meter.measure(lambda t: t.view(-1).t(), cache)
    assert m.bytes == 0
    from repro_torch.kernels import _build
    assert _build.METER is None
