"""The launch plan of the CUDA ``lru_scan`` (kernels/lru_scan.py:
``lru_plan``) and the plain scan it is held against.

The kernel gives each warp a chain of 32 consecutive channels of one batch
row and feeds it a and x through a ring of stages in shared memory. These
tests hold on the CPU what the card's tests cannot show apart: the chains
cover every (b, d) exactly once, block by block; recurrentgemma's serving
shapes (width 4096, S 2040 and 1020) give 128 chain-warps, one a block,
no more blocks than SMs, in both dtypes, with at least 24 KB of copies in
flight an SM; larger B puts more chain-warps in a block and keeps every
block's rings within the 227 KB a block may hold; the edge path is taken
exactly where D is no multiple of 32 or a or x is not 16-byte aligned.

The plain scan (the kernel's arithmetic: a float32 product, then a sum)
is chunk-invariant bit for bit and equals a numpy walk of the same two
roundings bit for bit. Against the JAX reference it holds to a few float32
ulps, not bits: ``repro.kernels.ref.lru_scan`` is an associative scan, and
XLA on the CPU contracts the Pallas kernel's ``a * h + x`` into one fused
multiply-add (one rounding where the TPU kernel's order has two). The
kernel itself is held on the card (``tests/test_torch_kernels_gpu.py``).
"""

import jax  # noqa: F401  (JAX on the CPU, as conftest.py sets)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lru_scan as JLS
from repro.kernels import ref as jref
from repro_torch.kernels import lru_scan as PLS

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
# the H100's shared memory: 228 KB an SM, of which a block may hold 227
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 232448

# (B, S, D): recurrentgemma's outer and middle prefill, B 2 with a start
# state, B 4, many rows, the odd (3, 37, 100) edge case, narrow and tiny
SHAPES = [(1, 2040, 4096), (1, 1020, 4096), (2, 300, 4096), (4, 2040, 4096),
          (3, 37, 100), (2, 5, 64), (1, 1, 1), (5, 9, 33), (64, 7, 4096),
          (40, 3, 4096), (9, 17, 96)]


def _chains(plan, b, d):
    """The (b, d) channels of each block's chain-warps, as the kernel walks
    them."""
    per_row = -(-d // PLS.CHAIN)
    out = []
    for blk in range(plan.blocks):
        for w in range(plan.warps):
            c = blk * plan.warps + w
            if c >= b * per_row:
                continue
            row, d0 = divmod(c, per_row)
            out.extend((row, ch) for ch in range(d0 * PLS.CHAIN,
                                                 min(d, (d0 + 1) * PLS.CHAIN)))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,d", SHAPES)
def test_chains_cover_every_channel_once(b, s, d, dtype):
    plan = PLS.lru_plan(b, s, d, dtype)
    assert plan.chains == b * -(-d // PLS.CHAIN)
    assert 1 <= plan.warps <= PLS.MAX_WARPS
    assert (plan.blocks - 1) * plan.warps < plan.chains
    assert plan.blocks * plan.warps >= plan.chains
    got = _chains(plan, b, d)
    assert len(got) == b * d
    assert sorted(got) == [(r, c) for r in range(b) for c in range(d)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,d", SHAPES)
def test_ring_fits_and_keeps_copies_in_flight(b, s, d, dtype):
    """A stage holds at most STAGE_BYTES of a and x a warp, in STAGES
    stages; the block's rings within RING_BYTES and what a block may hold
    (0 on the edge path)."""
    plan = PLS.lru_plan(b, s, d, dtype)
    assert plan.smem <= SMEM_PER_BLOCK
    if plan.edge:
        assert (plan.steps, plan.stages, plan.smem) == (0, 0, 0)
        return
    esz = torch.finfo(dtype).bits // 8
    row = 2 * PLS.CHAIN * esz
    assert plan.stages == PLS.STAGES
    assert 8 <= plan.steps and plan.steps % 8 == 0
    assert plan.steps * row <= PLS.STAGE_BYTES
    assert plan.smem == plan.warps * plan.stages * plan.steps * row
    assert plan.smem <= PLS.RING_BYTES
    # the copies ahead of the stage being walked, a block (one an SM)
    assert (plan.stages - 1) * plan.steps * row * plan.warps >= 24 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [2040, 1020])
def test_serving_shapes_fill_the_card(s, dtype):
    """recurrentgemma's width 4096 at B 1: 128 chains of 32 channels, one a
    block of one warp, on no more blocks than SMs (the block scheduler
    spreads them one an SM); 3 stages of 32 KB, T 128 (float32) or 256
    (bf16) steps, 64 KB of copies ahead of the stage being walked."""
    plan = PLS.lru_plan(1, s, 4096, dtype)
    esz = torch.finfo(dtype).bits // 8
    assert plan.chains == plan.blocks == 128 and plan.warps == 1
    assert plan.blocks <= PLS.SM_COUNT
    assert not plan.edge
    assert plan.steps == 512 // esz and plan.stages == 3
    assert plan.smem == 96 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
def test_more_chains_than_sms(dtype):
    """B 4 (512 chains): 128 blocks of 4 chain-warps, 3 stages of 16 KB a
    warp (192 KB a block: one an SM); B 64: blocks of 8 warps with stages
    of 8 KB, every block within one SM."""
    esz = torch.finfo(dtype).bits // 8
    plan = PLS.lru_plan(4, 2040, 4096, dtype)
    assert plan.chains == 512 and plan.chains > PLS.SM_COUNT
    assert (plan.warps, plan.blocks, plan.stages) == (4, 128, 3)
    assert plan.steps == 256 // esz
    assert plan.smem == PLS.RING_BYTES and 2 * plan.smem > SMEM_PER_SM
    big = PLS.lru_plan(64, 7, 4096, dtype)
    assert (big.warps, big.blocks) == (8, 1024)
    assert big.stages == 3 and big.steps == 128 // esz
    assert 2 * big.smem > SMEM_PER_SM


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 31, 32, 33, 64, 96, 100, 129, 4096, 4097])
def test_edge_path_exactly_where_rows_are_not_whole_aligned_chains(
        d, dtype, aligned):
    plan = PLS.lru_plan(3, 37, d, dtype, aligned=aligned)
    assert plan.edge == (d % PLS.CHAIN != 0 or not aligned)


def test_odd_serving_checks_take_the_edge_path():
    """chip_smoke.py's odd (3, 37, 100) case and a bf16 odd D."""
    assert PLS.lru_plan(3, 37, 100, torch.float32).edge
    assert PLS.lru_plan(1, 2040, 4095, torch.bfloat16).edge
    assert not PLS.lru_plan(2, 300, 4096, torch.float32).edge


def test_plan_refuses_empty_shapes_and_other_dtypes():
    with pytest.raises(ValueError):
        PLS.lru_plan(0, 4, 32, torch.float32)
    with pytest.raises(ValueError):
        PLS.lru_plan(1, 0, 32, torch.float32)
    with pytest.raises(TypeError):
        PLS.lru_plan(1, 4, 32, torch.float64)


def _inputs(seed, b, s, d):
    """Decays in (0.5, 0.999), inputs scaled by sqrt(1 - a^2), as the RG-LRU
    makes them, and a start state."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    x = (rng.standard_normal((b, s, d)) * np.sqrt(1 - a * a)).astype(
        np.float32)
    return a, x, rng.standard_normal((b, d)).astype(np.float32)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("k", [1, 16, 37, 63])
def test_plain_scan_is_chunk_invariant_bit_for_bit(k, with_h0):
    """A scan of [0, S) equals a scan of [0, k), then of [k, S) from its
    last state, bit for bit (the carry is the float32 output)."""
    a, x, h0 = (torch.from_numpy(z) for z in _inputs(3, 2, 64, 40))
    h0 = h0 if with_h0 else None
    whole, last = PLS.lru_scan(a, x, h0)
    head, mid = PLS.lru_scan(a[:, :k], x[:, :k], h0)
    tail, tail_last = PLS.lru_scan(a[:, k:], x[:, k:], mid)
    assert torch.equal(whole, torch.cat([head, tail], 1))
    assert torch.equal(last, tail_last)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_plain_scan_rounds_twice_a_step_and_matches_reference(with_h0):
    """Bit for bit the float32 walk ``h = a*h`` (rounded) ``+ x``
    (rounded) in order; within 1e-6 of the JAX reference (associative
    scan) and of the Pallas kernel in interpret mode (fused multiply-add
    on the CPU), h of order 1."""
    a, x, h0 = _inputs(4, 3, 37, 100)
    h0 = h0 if with_h0 else None
    got, last = PLS.lru_scan(torch.from_numpy(a), torch.from_numpy(x),
                             None if h0 is None else torch.from_numpy(h0))
    h = np.zeros((3, 100), np.float32) if h0 is None else h0.copy()
    walk = []
    for t in range(37):
        h = np.multiply(a[:, t], h, dtype=np.float32)
        h = np.add(h, x[:, t], dtype=np.float32)
        walk.append(h)
    assert np.array_equal(got.numpy(), np.stack(walk, 1))
    assert torch.equal(last, got[:, -1])
    jh0 = None if h0 is None else jnp.asarray(h0)
    assoc, _ = jref.lru_scan(jnp.asarray(a), jnp.asarray(x), jh0)
    kern, _ = JLS.lru_scan(jnp.asarray(a), jnp.asarray(x), jh0, block_s=16,
                           block_d=128, interpret=True)
    for want in (assoc, kern):
        err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
        assert err < 1e-6, err


def test_cpu_tensor_takes_the_plain_version():
    """On the CPU the wrapper computes the plain version (no plan, no
    launch), whatever the shape."""
    a, x, _ = (torch.from_numpy(z) for z in _inputs(5, 3, 37, 100))
    n0 = PLS.lru_scan.launches
    got, last = PLS.lru_scan(a, x)
    want, want_last = PLS.plain(a, x)
    assert torch.equal(got, want) and torch.equal(last, want_last)
    assert PLS.lru_scan.launches == n0
