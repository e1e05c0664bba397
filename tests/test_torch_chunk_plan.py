"""The split of the keys that the bf16 ``chunk_attention`` takes
(kernels/chunk_attention.py: ``chunk_split``, ``launch_plan``), and the
wrappers' alignment check.

The CUDA body runs one block per (64 flat (query, head) rows of a KV head,
range of keys) and merges the ranges' float32 partials in split order.
These tests hold on the CPU what the card's tests cannot show apart: the
ranges cover [0, Sk) once, in order, in whole 64-key tiles (bar the last);
the blocks stay within one wave of two blocks an SM; float32 takes one
range and no scratch; and the 16-byte alignment check refuses what the
bf16 bodies' copies cannot take. The walk itself (tiles skipped, a range
walked again) is counted by the kernel on the card
(``tests/test_torch_kernels_gpu.py``). Shapes only for the plan: the
tensors live on the ``meta`` device.
"""

import pytest
import torch

from repro_torch.kernels import chunk_attention as PCA

# (B, C, Sk, Hkv, G): qwen3's serving chunks (outer, middle), at B 4, the
# smoke shape, ragged chunks and keys, MQA, and a long context
SHAPES = [(1, 256, 1344, 8, 2), (1, 128, 896, 8, 2), (4, 256, 1344, 8, 2),
          (1, 4, 20, 2, 2), (2, 37, 91, 4, 2), (1, 65, 1, 8, 1),
          (3, 50, 120, 2, 4), (1, 256, 32768, 8, 2), (1, 16, 4096, 1, 16)]


@pytest.mark.parametrize("b,c,sk,hkv,g", SHAPES)
def test_split_covers_keys_once_in_order(b, c, sk, hkv, g):
    n_split, keys = PCA.chunk_split(b, c, sk, hkv, g)
    assert keys % PCA.KEY_TILE == 0 and keys > 0
    ranges = [range(i * keys, min(sk, (i + 1) * keys))
              for i in range(n_split)]
    assert all(len(r) > 0 for r in ranges)
    assert [k for r in ranges for k in r] == list(range(sk))


@pytest.mark.parametrize("b,c,sk,hkv,g", SHAPES)
def test_split_stays_within_one_wave(b, c, sk, hkv, g):
    """The row blocks times the ranges stay within WAVE_BLOCKS unless one
    range is all there is; a split whose ranges are longer than a tile
    could not double without passing it."""
    n_split, keys = PCA.chunk_split(b, c, sk, hkv, g)
    blocks = b * hkv * -(-c * g // PCA.ROW_TILE)
    assert n_split == 1 or blocks * n_split <= PCA.WAVE_BLOCKS
    if keys > PCA.KEY_TILE:
        assert blocks * 2 * n_split > PCA.WAVE_BLOCKS or n_split == 1


def test_serving_chunks_split():
    """qwen3's outer chunk (64 row blocks): 4 ranges of 384 keys, 256
    blocks; the middle's (32 blocks): 7 ranges of 128, 224 blocks; four
    slots fill the card with one range."""
    assert PCA.chunk_split(1, 256, 1344, 8, 2) == (4, 384)
    assert PCA.chunk_split(1, 128, 896, 8, 2) == (7, 128)
    assert PCA.chunk_split(4, 256, 1344, 8, 2) == (1, 1344)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("b,c,sk,hkv,g", SHAPES[:4])
def test_launch_plan_scratch(b, c, sk, hkv, g):
    h, dh = hkv * g, 128
    q, k = _meta(b, c, h, dh), _meta(b, sk, hkv, dh)
    n_split, keys, shape = PCA.launch_plan(q, k)
    assert (n_split, keys) == PCA.chunk_split(b, c, sk, hkv, g)
    assert shape == ((b * c * h * n_split * (dh + 2),) if n_split > 1
                     else None)
    f32 = PCA.launch_plan(q.float(), k.float())
    assert f32[0] == 1 and f32[1] >= sk and f32[2] is None


def test_split_rejects_empty_shapes():
    with pytest.raises(ValueError):
        PCA.chunk_split(1, 0, 64, 8, 2)


@pytest.mark.parametrize("offset,width,bad", [(0, 64, False), (1, 64, True),
                                              (8, 64, False), (0, 12, True)])
def test_alignment_check(offset, width, bad):
    """The bf16 bodies' 16-byte copies need 16-byte base pointers and row
    strides: the wrappers' check refuses a view one element off, or rows
    of 24 bytes, before anything is launched."""
    buf = torch.zeros(offset + 4 * width, dtype=torch.bfloat16)
    t = buf[offset:].view(4, width)
    if bad:
        with pytest.raises(ValueError, match="16-byte"):
            PCA._check_aligned("chunk_attention", t)
    else:
        PCA._check_aligned("chunk_attention", t)


def test_walk_counts_need_the_card():
    """The walk is counted by the bf16 bodies on the card: on CPU tensors
    the counting launches refuse, where the wrappers take the plain
    versions."""
    q, k = torch.zeros(1, 4, 4, 64), torch.zeros(1, 12, 2, 64)
    qp = torch.zeros(1, 4, dtype=torch.int32)
    kp = torch.zeros(1, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        PCA.chunk_walk(q.bfloat16(), k.bfloat16(), k.bfloat16(), qp, kp)
    ql, qr = torch.zeros(1, 4, 4, 512), torch.zeros(1, 4, 4, 64)
    lat, rope = torch.zeros(1, 12, 512), torch.zeros(1, 12, 64)
    with pytest.raises(ValueError, match="CUDA"):
        PCA.mla_chunk_walk(ql.bfloat16(), qr.bfloat16(), lat.bfloat16(),
                           rope.bfloat16(), qp, kp, scale=0.1)
