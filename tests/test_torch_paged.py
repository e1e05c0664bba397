"""Paged KV serving of repro_torch on the CPU.

  * the paged engine decodes bit for bit like the port's dense engine —
    slots at mixed SOI phases, a mid-decode insert, a free and a re-insert
    into the freed slot (the middle's mid-window writes go to the null
    page instead of being row-masked);
  * against the JAX paged engine on the same weights (pp and fp): logits
    within 5e-4 at every step, the same page maps, refcounts and pool
    stats — with bucketed and with chunked prefill;
  * the page map is uploaded only when the host table changed.
Sizes: qwen3 smoke config in float32, page size 4, max_len 16.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.qwen3_1_7b as Q
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import transformer as JT
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine

torch.set_num_threads(1)

S = 16
ATOL = 5e-4


def _random_params(cfg, seed=0):
    """Reference-shaped parameter tree, every leaf drawn by numpy."""
    shapes, _ = split_axes(jax.eval_shape(
        lambda k: JT.init(k, cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(x):
        if len(x.shape) == 1:
            s = 0.3
        elif x.shape[0] == cfg.vocab:
            s = 1.0
        elif len(x.shape) == 3 and x.shape[-1] == cfg.d_model:
            s = float(np.prod(x.shape[:-1])) ** -0.5
        else:
            s = x.shape[0] ** -0.5
        return (rng.standard_normal(x.shape) * s).astype(np.float32)

    return jax.tree.map(draw, shapes)


@functools.lru_cache(maxsize=None)
def _setup(mode):
    jc = dataclasses.replace(Q.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(PQ.smoke_config(soi=mode), dtype="float32")
    np_params = _random_params(jc)
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = from_jax_params(np_params, pc, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (4, S)).astype(np.int32)
    return jc, pc, jparams, model, tokens


def _drive(eng, params, tokens, *, jax_side=False, n_steps=9):
    """Slots 0 and 1 (offsets 5, 6: phases 1 and 0) from the start, slot 2
    (offset 8) after 2 steps, slot 0 freed after 4 and row 3 re-inserted
    into it (offset 7). Inputs are teacher-forced. Returns {(slot, step):
    logits} as numpy."""
    if jax_side:
        conv, pos_set = jnp.asarray, (lambda a, i, v: a.at[i].set(v))
    else:
        conv = torch.from_numpy

        def pos_set(a, i, v):
            a = a.clone()
            a[i] = int(v)
            return a
    ds = eng.init_decode_state(params)
    cur = {}

    def put(slot, row, off):
        nonlocal ds
        ds = eng.insert(eng.prefill(params, conv(tokens[row, :off])), ds,
                        slot)
        cur[slot] = (row, off)

    put(0, 0, 5)
    put(1, 1, 6)
    out = {}
    for k in range(n_steps):
        if k == 2:
            put(2, 2, 8)
        if k == 4:
            ds = eng.free_slot(ds, 0)
            del cur[0]
            put(0, 3, 7)
        forced = ds["tokens"]
        for sl, (row, c) in cur.items():
            forced = pos_set(forced, sl, tokens[row, c])
        ds, res = eng.generate(params, dict(ds, tokens=forced))
        for sl, (row, c) in list(cur.items()):
            out[sl, k] = np.asarray(res.logits[sl])
            cur[sl] = (row, c + 1)
    return out


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_paged_engine_bit_exact_vs_dense_engine(mode):
    _, pc, _, model, tokens = _setup(mode)
    kw = dict(max_concurrent_decodes=3, max_len=S, device="cpu")
    dense = _drive(SOIEngine(pc, **kw), model, tokens)
    paged_eng = SOIEngine(pc, paged=True, page_size=4, **kw)
    paged = _drive(paged_eng, model, tokens)
    assert dense.keys() == paged.keys()
    for key in dense:
        assert np.array_equal(dense[key], paged[key]), key
    assert paged_eng.pool_stats()["outer"]["used"] > 0


@pytest.mark.parametrize("mode,chunk", [("pp", None), ("fp", None),
                                        ("pp", 4)])
def test_paged_engine_matches_reference_engine(mode, chunk):
    jc, pc, jparams, model, tokens = _setup(mode)
    kw = dict(max_concurrent_decodes=3, max_len=S, paged=True, page_size=4,
              prefill_chunk=chunk)
    jeng = JEngine(jc, **kw)
    peng = SOIEngine(pc, device="cpu", **kw)
    ref = _drive(jeng, jparams, tokens, jax_side=True)
    got = _drive(peng, model, tokens)
    assert ref.keys() == got.keys()
    for key in ref:
        err = float(np.max(np.abs(ref[key] - got[key])))
        assert err < ATOL, (mode, chunk, key, err)
    for name in ("_pt_outer", "_pt_mid"):
        jt, pt = getattr(jeng, name), getattr(peng, name)
        assert np.array_equal(jt.map, pt.map), name
        assert np.array_equal(jt.refs, pt.refs), name
    assert jeng.pool_stats() == peng.pool_stats()


def test_page_map_uploads_only_when_the_table_changes(monkeypatch):
    _, pc, _, model, tokens = _setup("pp")
    eng = SOIEngine(pc, max_concurrent_decodes=2, max_len=S, paged=True,
                    page_size=4, device="cpu")
    ds = eng.init_decode_state(model)
    ds = eng.insert(eng.prefill(model, torch.from_numpy(tokens[0, :5])), ds,
                    0)
    uploads = []
    orig = eng._upload_map

    def counting(name, pt):
        uploads.append(name)
        return orig(name, pt)

    monkeypatch.setattr(eng, "_upload_map", counting)
    # clock 5: the insert changed both maps; 6, 7: nothing new; 8: position
    # 8 opens outer page 2 and frame 4 opens middle page 1
    want = [["outer", "mid"], [], [], ["outer", "mid"]]
    for step, expect in enumerate(want):
        uploads.clear()
        ds, _ = eng.generate(model, ds)
        assert uploads == expect, (step, uploads)
    for name, pt in (("outer", eng._pt_outer), ("mid", eng._pt_mid)):
        assert torch.equal(ds["model"]["pages"][name],
                           torch.from_numpy(pt.map))
