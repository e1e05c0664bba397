"""A copy-on-write flush of repro_torch as one ``copy_pages_leaves`` call.

On the CPU:

  * the leaf table the CUDA launch uploads (``page_copy.pack_leaves``):
    each leaf's pointer, row bytes and pages in leaf order, its pairs'
    offset and count, then the pairs, padding pairs kept, one copy of the
    pairs that a page table's leaves share;
  * the plain ``copy_pages_leaves`` over leaves of mixed dtype and row
    width (bf16 K/V, float32, int32 positions, MLA latent and rope) equals
    the JAX ``copy_pages`` (``repro.kernels.ops``, and the Pallas kernel in
    interpret mode) applied leaf by leaf, bit for bit;
  * the paged engines of tests/test_torch_prefix_cache.py (qwen3 smoke, pp)
    and tests/test_torch_mla_prefix_cache.py (the ``mla-test`` stack) on
    their wrapping schedule: every flush is one ``copy_pages_leaves`` call
    over every pool leaf of its tables (the engine's ``cow_flushes``
    counts them), and tokens, logits, pools and prefix-cache counters are
    bit for bit those of the same engine flushing one ``copy_pages`` call
    a leaf.

The CUDA kernel is held on the card (``tests/test_torch_kernels_gpu.py``).
"""

import dataclasses

import jax  # noqa: F401  (JAX on the CPU, as conftest.py sets)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import page_copy as JPC
from repro_torch.configs import base as PB
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.engine import SOIEngine
from repro_torch.engine.soi_engine import _table_groups
from repro_torch.kernels import ops
from repro_torch.kernels import page_copy as PPC
from repro_torch.models import transformer as PT
from repro_torch.models.decode import is_attn_cache

torch.set_num_threads(1)

S = 16
KW = dict(max_concurrent_decodes=2, max_len=S, paged=True, page_size=4,
          prefill_chunk=4)

# (page shape after the page axis, torch dtype, numpy dtype for JAX): a
# bf16 K/V leaf, a float32 one, int32 positions (64-byte rows at page 16),
# MLA latent and rope leaves, and a 12-byte row (no 16-byte vectors)
LEAVES = [((16, 2, 8), torch.bfloat16, jnp.bfloat16),
          ((4, 3), torch.float32, np.float32),
          ((16,), torch.int32, np.int32),
          ((16, 32), torch.bfloat16, jnp.bfloat16),
          ((16, 8), torch.bfloat16, jnp.bfloat16),
          ((3,), torch.int32, np.int32)]


def _leaves(seed, n_pages):
    rng = np.random.default_rng(seed)
    out = []
    for shape, dt, _ in LEAVES:
        vals = rng.standard_normal((n_pages,) + shape).astype(np.float32)
        if dt == torch.int32:
            vals = rng.integers(-1, 10_000, (n_pages,) + shape).astype(
                np.int32)
        out.append(vals)
    return out


def _pairs():
    """Per leaf: a COW set of an outer table (3 pairs), a middle table's (1
    pair), none, and padding (0, 0) pairs as the reference pads them."""
    return ([[1, 3, 5, 0, 0], [2], [], [4, 0], [4, 0], [6, 1, 0]],
            [[7, 8, 9, 0, 0], [6], [], [2, 0], [2, 0], [7, 9, 0]])


def test_pack_leaves_table():
    pools = [torch.from_numpy(v).to(dt) for v, (_, dt, _) in
             zip(_leaves(0, 10), LEAVES)]
    srcs, dsts = _pairs()
    table = PPC.pack_leaves(pools, srcs, [np.asarray(d, np.int32)
                                          for d in dsts])
    n = len(pools)
    heads = table[:n * len(PPC.FIELDS)].reshape(n, len(PPC.FIELDS))
    counts = [len(s) for s in srcs]
    assert table.dtype == np.int64
    assert heads[:, 0].tolist() == [p.data_ptr() for p in pools]
    assert heads[:, 1].tolist() == [16 * 2 * 8 * 2, 4 * 3 * 4,
                                    16 * 4, 16 * 32 * 2, 16 * 8 * 2, 3 * 4]
    assert heads[:, 2].tolist() == [10] * n
    assert heads[:, 3].tolist() == np.cumsum([0] + counts[:-1]).tolist()
    assert heads[:, 4].tolist() == counts
    pairs = table[n * len(PPC.FIELDS):].reshape(-1, 2)
    assert pairs.tolist() == [[s, d] for ss, ds in zip(srcs, dsts)
                              for s, d in zip(ss, ds)]


def test_pack_leaves_shares_a_tables_pairs():
    """Leaves given the same pair lists (one page table's leaves, as the
    engine gives them) point at one copy of the pairs."""
    pools = [torch.zeros(5, 2), torch.zeros(5, 3, dtype=torch.int32),
             torch.zeros(7, 4)]
    outer = (np.asarray([1, 2, 0]), np.asarray([3, 4, 0]))
    mid = ([5], [6])
    table = PPC.pack_leaves(pools, [outer[0], outer[0], mid[0]],
                            [outer[1], outer[1], mid[1]])
    heads = table[:15].reshape(3, 5)
    assert heads[:, 3:].tolist() == [[0, 3], [0, 3], [3, 1]]
    assert table[15:].reshape(-1, 2).tolist() == [[1, 3], [2, 4], [0, 0],
                                                  [5, 6]]


def test_pack_leaves_refuses_ragged_pairs():
    pools = [torch.zeros(4, 2)]
    with pytest.raises(ValueError):
        PPC.pack_leaves(pools, [[1, 2]], [[3]])
    with pytest.raises(ValueError):
        PPC.pack_leaves(pools, [[1]], [])
    with pytest.raises(TypeError):
        PPC.pack_leaves(pools, [torch.tensor([1])], [[2]])


def test_plain_copy_pages_leaves_matches_reference_leaf_by_leaf():
    vals = _leaves(1, 10)
    srcs, dsts = _pairs()
    pools = [torch.from_numpy(v).to(dt) for v, (_, dt, _) in
             zip(vals, LEAVES)]
    n0 = ops.copy_pages.launches
    same = ops.copy_pages_leaves(pools, srcs, dsts)
    assert same is pools and ops.copy_pages.launches == n0
    for i, (v, (_, dt, jdt)) in enumerate(zip(vals, LEAVES)):
        jp = jnp.asarray(v).astype(jdt)
        js = jnp.asarray(np.asarray(srcs[i], np.int32))
        jd = jnp.asarray(np.asarray(dsts[i], np.int32))
        got = pools[i].float().numpy() if dt == torch.bfloat16 else (
            pools[i].numpy())
        for want in (jops.copy_pages(jp, js, jd),
                     JPC.copy_pages(jp, js, jd, interpret=True)
                     if len(srcs[i]) else jp):
            want = np.asarray(want.astype(jnp.float32) if dt ==
                              torch.bfloat16 else want)
            assert np.array_equal(got, want), i


def _mla_cfg():
    mla = PB.AttnCfg(kind="mla", n_heads=4, n_kv=4, head_dim=0, q_lora=16,
                     kv_lora=16, qk_nope=16, qk_rope=8, v_head=16)
    blk = PB.BlockCfg(attn=mla, mlp=PB.MLPCfg(kind="swiglu", d_ff=64))
    return PB.ModelCfg(name="mla-test", d_model=32, vocab=128,
                       segments=(PB.Segment(blocks=(blk,), n_layers=2),),
                       tie_embeddings=True, dtype="float32")


CONFIGS = {
    "qwen3_pp": lambda: dataclasses.replace(PQ.smoke_config(soi="pp"),
                                            dtype="float32"),
    "mla": _mla_cfg,
}


def _per_leaf(pools, srcs, dsts):
    """The flush as it was: one ``copy_pages`` call a leaf."""
    for pool, s, d in zip(pools, srcs, dsts, strict=True):
        ops.copy_pages(pool, torch.as_tensor(np.asarray(s, np.int32)),
                       torch.as_tensor(np.asarray(d, np.int32)))
    return pools


def _serve(cfg, model, tokens, flush, calls, monkeypatch):
    """Two 12-token prompts sharing 8 tokens, 10 greedy steps on the paged
    prefix-cache engine, every ring wrapping at 16 onto shared pages; each
    call of the flush records the number of leaves it was given. Returns
    the tokens, logits, final pools, counters, the engine's flush count and
    the pool leaves of each page table."""
    def counted(pools, srcs, dsts):
        calls.append(len(pools))
        return flush(pools, srcs, dsts)

    monkeypatch.setattr(ops, "copy_pages_leaves", counted)
    eng = SOIEngine(cfg, device="cpu", prefix_cache=True, **KW)
    toks, logits = {}, []
    ds = eng.init_decode_state(model)
    for slot in (0, 1):
        prefix = eng.prefill(model, torch.from_numpy(tokens[slot]))
        toks[slot] = [int(prefix.first_token[0])]
        ds = eng.insert(prefix, ds, slot)
    for _ in range(10):
        ds, res = eng.generate(model, ds)
        logits.append(res.logits.clone())
        data = res.convert_to_numpy().data
        for slot in toks:
            toks[slot].append(int(data[slot, 0]))
    leaves = {table: sum(len(c) for g in groups for c in ds["model"][g]
                         if is_attn_cache(c))
              for table, groups in _table_groups(cfg).items()}
    pools = [leaf.clone() for groups in _table_groups(cfg).values()
             for g in groups for c in ds["model"][g] for leaf in c.values()]
    return (toks, logits, pools, eng.prefix_cache_stats, eng.cow_flushes,
            leaves)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_flushes_once_and_equals_the_per_leaf_flush(name,
                                                           monkeypatch):
    cfg = CONFIGS[name]()
    model = PT.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    tokens[1, :8] = tokens[0, :8]
    one, per_leaf = [], []
    toks, logits, pools, stats, flushes, leaves = _serve(
        cfg, model, tokens, PPC.copy_pages_leaves, one, monkeypatch)
    want = _serve(cfg, model, tokens, _per_leaf, per_leaf, monkeypatch)
    assert stats["cow_copies"] > 0 and stats["hits"] == 1
    # one call a flush, over every pool leaf of the tables it copies in
    # (k, v, pos or latent, rope, pos of each attention layer)
    assert flushes == len(one) > 0 and one == per_leaf
    sizes = {*leaves.values(), sum(leaves.values())}
    assert all(n in sizes for n in one) and min(leaves.values()) >= 3
    assert toks == want[0] and stats == want[3] and flushes == want[4]
    for a, b in zip(logits, want[1]):
        assert torch.equal(a, b)
    assert len(pools) == len(want[2])
    for a, b in zip(pools, want[2]):
        assert torch.equal(a, b)
