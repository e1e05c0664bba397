"""The split of S that the decode reads share (kernels/decode_attention.py:
``decode_split``, ``scratch_shape``, ``launch_plan``,
``paged_launch_plan``), and the paged absorbed-MLA read's (``mla_split``,
``paged_mla_launch_plan``).

The CUDA reads run one block per (slot, KV head, range of keys) and merge
the ranges' partials in split order; the paged read equals the dense read
bit for bit only if both take the same ranges. These tests hold the plan
on the CPU: the ranges cover [0, S) once, in order, in whole 64-key tiles
(bar the last); a dense ring and a paged map of the same logical rows get
the same plan whatever the page size; the scratch is what the kernels
index. The MLA read's bf16 body holds 64 heads of a slot a block, one
block an SM: its ranges cover [0, S) once, in order, in whole 32-key tiles
(bar the last), deepseek-v2's serving reads fit one wave, and the plan is
a function of ``n_pp·P`` alone. Shapes only: the tensors live on the
``meta`` device.
"""

import pytest
import torch

from repro_torch.kernels import decode_attention as PDA

# (B, S, Hkv): the serving reads (recurrentgemma outer / middle, qwen3
# outer / middle), the split's edges and a long context
SHAPES = [(4, 2048, 1), (4, 1280, 1), (4, 1088, 8), (4, 768, 8), (1, 1, 1),
          (4, 40, 1), (4, 65, 8), (3, 513, 2), (1, 32768, 8), (64, 4096, 8)]


@pytest.mark.parametrize("b,s,hkv", SHAPES)
def test_split_covers_rows_once_in_order(b, s, hkv):
    n_split, keys = PDA.decode_split(b, s, hkv)
    assert keys % PDA.SPLIT_TILE == 0 and 0 < keys <= PDA.MAX_SPLIT_KEYS
    ranges = [range(i * keys, min(s, (i + 1) * keys)) for i in range(n_split)]
    assert all(len(r) > 0 for r in ranges)
    assert [k for r in ranges for k in r] == list(range(s))


def test_split_fills_the_card_at_recurrentgemma_serving_read():
    """B 4, one KV head, a ring of 2048: 32 ranges of 64 keys, 128 blocks
    (16 before the split). Elsewhere at most one range a (slot, KV head)
    past WAVE_BLOCKS, unless the ranges are at their longest (a long
    context) or shortest."""
    assert PDA.decode_split(4, 2048, 1) == (32, 64)
    for b, s, hkv in SHAPES:
        n_split, keys = PDA.decode_split(b, s, hkv)
        assert (b * hkv * (n_split - 1) < PDA.WAVE_BLOCKS
                or keys in (PDA.SPLIT_TILE, PDA.MAX_SPLIT_KEYS)), (b, s, hkv)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("p_sz", [1, 4, 16])
@pytest.mark.parametrize("b,s,h,hkv,dh", [(4, 2048, 16, 1, 256),
                                          (4, 1088, 16, 8, 128),
                                          (3, 96, 16, 1, 256)])
def test_dense_and_paged_reads_take_one_plan(p_sz, b, s, h, hkv, dh):
    q = _meta(b, h, dh)
    dense = PDA.launch_plan(q, _meta(b, s, hkv, dh))
    n_pp = s // p_sz
    paged = PDA.paged_launch_plan(q, _meta(b * n_pp + 1, p_sz, hkv, dh),
                                  _meta(b, n_pp, dtype=torch.int32))
    assert dense == paged


@pytest.mark.parametrize("dh", PDA.HEAD_DIMS)
def test_scratch_is_what_the_kernels_index(dh):
    """float32 partial accumulators (B, H, n_split, dh), then (m, l) pairs
    (B, H, n_split, 2), their start 16-byte aligned."""
    b, s, h, hkv = 4, 2048, 16, 1
    n_split, keys, shape = PDA.launch_plan(_meta(b, h, dh),
                                           _meta(b, s, hkv, dh))
    assert shape == PDA.scratch_shape(b, h, dh, n_split)
    assert shape == (b * h * n_split * dh + b * h * n_split * 2,)
    assert b * h * n_split * dh * 4 % 16 == 0


def test_split_refuses_empty_shapes():
    with pytest.raises(ValueError):
        PDA.decode_split(4, 0, 1)


# (B, S, head groups): deepseek-v2's outer (n_pp 68) and middle (48) reads
# at page 16, one slot, a third head group, short, ragged and long rows
MLA_SHAPES = [(4, 1088, 2), (4, 768, 2), (1, 1088, 2), (4, 1088, 3),
              (2, 160, 2), (3, 16, 1), (4, 33, 2), (1, 32768, 2),
              (8, 131072, 2), (200, 64, 2)]


@pytest.mark.parametrize("b,s,groups", MLA_SHAPES)
def test_mla_split_covers_rows_once_in_order(b, s, groups):
    n_split, keys = PDA.mla_split(b, s, groups)
    assert keys % PDA.MLA_KEY_TILE == 0
    assert 0 < keys <= PDA.MLA_MAX_SPLIT_KEYS
    ranges = [range(i * keys, min(s, (i + 1) * keys)) for i in range(n_split)]
    assert all(len(r) > 0 for r in ranges)
    assert [k for r in ranges for k in r] == list(range(s))


@pytest.mark.parametrize("b,s,groups", MLA_SHAPES)
def test_mla_split_fits_one_wave_where_it_can(b, s, groups):
    """At most MLA_WAVE_BLOCKS blocks (one an SM) unless a range is at its
    longest or the slots alone pass a wave; no shorter whole-tile range
    would keep the blocks within it."""
    n_split, keys = PDA.mla_split(b, s, groups)
    blocks = b * groups * n_split
    assert (blocks <= PDA.MLA_WAVE_BLOCKS
            or keys == PDA.MLA_MAX_SPLIT_KEYS or n_split == 1)
    if keys > PDA.MLA_KEY_TILE and keys < PDA.MLA_MAX_SPLIT_KEYS:
        shorter = keys - PDA.MLA_KEY_TILE
        assert b * groups * -(-s // shorter) > PDA.MLA_WAVE_BLOCKS


def test_mla_serving_reads_split():
    """deepseek-v2 (B 4, H 128: two head groups): the outer read's 1088
    rows in 12 ranges of 96 (3 tiles, 96 blocks), the middle's 768 in 12
    of 64 (2 tiles, 96 blocks); 16 ranges would leave 68 and 48 keys a
    range, no fewer tiles."""
    assert PDA.mla_split(4, 68 * 16, 2) == (12, 96)
    assert PDA.mla_split(4, 48 * 16, 2) == (12, 64)


@pytest.mark.parametrize("p_sz", [1, 4, 16, 32])
def test_mla_plan_counts_dense_rows_whatever_the_page_size(p_sz):
    b, h, s = 4, 128, 1088
    q_lat, q_rope = _meta(b, h, 512), _meta(b, h, 64)
    n_pp = s // p_sz
    plan = PDA.paged_mla_launch_plan(q_lat, q_rope,
                                     _meta(b * n_pp + 1, p_sz,
                                           dtype=torch.int32),
                                     _meta(b, n_pp, dtype=torch.int32))
    n_split, keys = PDA.mla_split(b, s, 2)
    assert plan == (n_split, keys, PDA.scratch_shape(b, h, 512, n_split))


def test_mla_plan_scalar_body_takes_one_range():
    """float32 and the test widths (16, 8) keep the scalar body: one range
    of all n_pp·P rows, no scratch; ragged H is the bf16 body's alone."""
    pos, pm = _meta(13, 4, dtype=torch.int32), _meta(3, 4, dtype=torch.int32)
    assert PDA.paged_mla_launch_plan(_meta(3, 8, 512, dtype=torch.float32),
                                     _meta(3, 8, 64, dtype=torch.float32),
                                     pos, pm) == (1, 16, None)
    assert PDA.paged_mla_launch_plan(_meta(3, 8, 16), _meta(3, 8, 8), pos,
                                     pm) == (1, 16, None)
    n_split, _, shape = PDA.paged_mla_launch_plan(_meta(3, 72, 512),
                                                  _meta(3, 72, 64), pos, pm)
    assert shape == PDA.scratch_shape(3, 72, 512, n_split)


def test_mla_split_refuses_empty_shapes():
    for args in ((0, 64, 2), (4, 0, 2), (4, 64, 0)):
        with pytest.raises(ValueError):
            PDA.mla_split(*args)
