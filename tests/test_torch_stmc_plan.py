"""The launch plan of the CUDA ``stmc_conv`` (kernels/stmc_conv.py:
``stmc_plan``).

The kernel splits K*Cin across the blocks of a thread block cluster, whose
partials meet in rank order, and loads 16 bytes of a weight row a thread.
These tests hold on the CPU what the card's tests cannot show apart: the
splits cover K*Cin once, in rank order, none empty, within the portable
cluster of 8; every conv of the full-width soi-unet-dns stream at B 1 runs
on at least 132 blocks but decoder 7 (Cout 128: 16 tiles of one 32-byte
sector a row in float32, 8 of two in bf16, x 8 splits), and on no more
than the SMs hold at once (two an SM; encoders 6, 7 and decoder 1 at 4
splits); from 16 rows of B the blocks are 2-3 an SM; the 16-byte path is
taken exactly where Cout times the element size is a multiple of 16; a
block holds every row of B up to 32. The kernel itself is held on the
card (``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import soi_unet_dns
from repro_torch.kernels import stmc_conv as PSC
from repro_torch.models import unet as U

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


def _unet_convs():
    """(K*Cin, Cout) of the 14 convs of full-width soi-unet-dns."""
    cfg = soi_unet_dns.config()
    enc_io, dec_io = U._layer_io(cfg)
    return [(cfg.kernel * ci, co) for ci, co in enc_io + dec_io]


# (B, K*Cin, Cout): the U-Net's decoder 2 at B 1 and 32, encoder 7 at 32,
# decoder 7 at 1, the ragged edge, tiny and odd shapes, many rows of B
SHAPES = [(1, 7248, 664), (32, 7248, 664), (32, 3624, 1296), (1, 3696, 128),
          (3, 192, 129), (2, 384, 128), (5, 40, 33), (1, 1, 1), (7, 17, 5),
          (40, 70, 36), (100, 129, 1000)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,kc,cout", SHAPES)
def test_splits_cover_kc_once_in_rank_order(b, kc, cout, dtype):
    plan = PSC.stmc_plan(b, kc, cout, dtype)
    assert 1 <= plan.splits <= PSC.MAX_SPLITS
    assert plan.splits & (plan.splits - 1) == 0       # 1, 2, 4 or 8
    ranges = [range(i * plan.keys_per_split,
                    min(kc, (i + 1) * plan.keys_per_split))
              for i in range(plan.splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [k for r in ranges for k in r] == list(range(kc))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,kc,cout", SHAPES)
def test_tiles_and_rows(b, kc, cout, dtype):
    """Columns a block: 1, 2, 4 or 8 sixteen-byte groups; rows: the least
    power of two >= B, at most 32, the grid's y covering the rest; the
    block count is what the kernel launches."""
    plan = PSC.stmc_plan(b, kc, cout, dtype)
    group = 16 // (torch.finfo(dtype).bits // 8)
    assert plan.cols // group in (2, 4, 8) and plan.cols % group == 0
    assert plan.rows == min(32, 1 << (b - 1).bit_length())
    assert plan.rows >= min(b, 32) and (plan.rows == 1 or plan.rows < 2 * b)
    assert plan.blocks == (-(-cout // plan.cols) * plan.splits
                           * -(-b // plan.rows))
    per_row_tile = plan.blocks // -(-b // plan.rows)
    if plan.splits > 1:
        held = 3 if plan.rows >= PSC.FMA_ROWS else 2
        assert per_row_tile <= held * PSC.SM_COUNT


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_unet_conv_fills_the_card_at_b1(dtype):
    convs = _unet_convs()
    assert len(convs) == 14
    assert (7248, 664) in convs and (3696, 128) in convs
    group = 16 // (torch.finfo(dtype).bits // 8)
    for kc, cout in convs:
        plan = PSC.stmc_plan(1, kc, cout, dtype)
        # all resident at once: two blocks an SM
        assert plan.blocks <= 2 * PSC.SM_COUNT, (kc, cout, plan)
        if plan.splits < PSC.MAX_SPLITS:
            assert 2 * plan.blocks > 2 * PSC.SM_COUNT
        if cout == 128:
            # decoder 7: the narrowest tile, a 32-byte sector a row
            assert plan.cols == 2 * group
            assert plan.blocks == 128 // plan.cols * 8 < PSC.SM_COUNT
            continue
        assert plan.blocks >= PSC.SM_COUNT, (kc, cout, plan)
        # the widest tile that does at 8 splits: twice as wide would not
        if plan.cols < 8 * group:
            assert (-(-cout // (2 * plan.cols)) * PSC.MAX_SPLITS
                    < PSC.SM_COUNT)


def test_serving_plans():
    """Decoder 2 (the most weights) at B 1: 21 column tiles of 32 x 8
    splits of 906 rows, 168 blocks, 16-byte loads, in both dtypes; at B 32
    42 tiles of 16 (336 blocks, 2.5 an SM); encoder 7 at B 32: 41 tiles of
    32 x 8 splits (328)."""
    for dt in DTYPES:
        assert (PSC.stmc_plan(1, 7248, 664, dt)
                == PSC.StmcPlan(32, 8, 906, 1, 168, True))
        assert (PSC.stmc_plan(32, 7248, 664, dt)
                == PSC.StmcPlan(16, 8, 906, 32, 336, True))
    assert (PSC.stmc_plan(32, 3624, 1296, torch.float32)
            == PSC.StmcPlan(32, 8, 454, 32, 328, True))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cout", [1, 2, 3, 4, 8, 16, 33, 128, 129, 664, 1296])
def test_16_byte_path_exactly_where_rows_are_whole_groups(cout, dtype):
    esz = torch.finfo(dtype).bits // 8
    plan = PSC.stmc_plan(2, 64, cout, dtype)
    assert plan.vec16 == (cout * esz % 16 == 0)


def test_plan_refuses_empty_shapes_and_other_dtypes():
    with pytest.raises(ValueError):
        PSC.stmc_plan(0, 64, 8, torch.float32)
    with pytest.raises(ValueError):
        PSC.stmc_plan(1, 64, 0, torch.float32)
    with pytest.raises(TypeError):
        PSC.stmc_plan(1, 64, 8, torch.float64)


def test_cpu_tensor_takes_the_plain_version():
    """On the CPU the wrapper computes the plain version (no plan, no
    launch), whatever the shape."""
    rng = np.random.default_rng(0)
    win = torch.from_numpy(rng.standard_normal((3, 3, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 7, 5)).astype(np.float32))
    n0 = PSC.stmc_conv.launches
    assert torch.equal(PSC.stmc_conv(win, w), PSC.plain(win, w))
    assert PSC.stmc_conv.launches == n0
