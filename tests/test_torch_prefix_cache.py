"""The copy-on-write prefix page cache of repro_torch on the CPU.

Two 12-token prompts sharing their first 8 tokens go through a paged,
chunked engine (max_len 16, page size 4, chunk 4) and decode 10 greedy
steps, so every ring wraps at position 16 onto pages the prefix index
still shares: each slot copies them on write, and a copy needs a page the
pool only has after evicting the index entry.

  * warm (prefix cache on) equals cold (off) bit for bit, logits and
    tokens, pp and fp;
  * the prefix-cache counters equal the JAX engine's on the same schedule,
    and the logits agree with it within 5e-4 (same tokens);
  * a sharer's free and its slot's re-insert leave the other sharer's
    decode unchanged, and the index keeps the prefix hittable after its
    last sharer left.
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
KW = dict(max_concurrent_decodes=2, max_len=S, paged=True, page_size=4,
          prefill_chunk=4)
STATS = ("hits", "misses", "tokens_skipped", "pages_shared", "cow_copies",
         "evictions")


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
        0, jc.vocab, (3, S)).astype(np.int32)
    tokens[1, :8] = tokens[0, :8]
    return jc, pc, jparams, model, tokens


def _greedy(eng, params, prompts, conv, n_steps=10):
    """Insert every prompt, decode ``n_steps`` greedy steps. Returns the
    per-step logits of each slot (numpy) and each slot's tokens."""
    ds = eng.init_decode_state(params)
    toks = {}
    for slot, p in enumerate(prompts):
        prefix = eng.prefill(params, conv(p))
        toks[slot] = [int(np.asarray(prefix.first_token)[0])]
        ds = eng.insert(prefix, ds, slot)
    logits = []
    for _ in range(n_steps):
        ds, res = eng.generate(params, ds)
        data = np.asarray(res.convert_to_numpy().data)
        logits.append(np.asarray(res.logits))
        for slot in toks:
            toks[slot].append(int(data[slot, 0]))
    return logits, toks


@functools.lru_cache(maxsize=None)
def _runs(mode):
    jc, pc, jparams, model, tokens = _setup(mode)
    prompts = [tokens[0, :12], tokens[1, :12]]
    jeng = JEngine(jc, prefix_cache=True, **KW)
    ref = _greedy(jeng, jparams, prompts, jnp.asarray)
    warm_eng = SOIEngine(pc, device="cpu", prefix_cache=True, **KW)
    warm = _greedy(warm_eng, model, prompts, torch.from_numpy)
    cold = _greedy(SOIEngine(pc, device="cpu", **KW), model, prompts,
                   torch.from_numpy)
    return (ref, {k: jeng.prefix_cache_stats[k] for k in STATS}, warm,
            {k: warm_eng.prefix_cache_stats[k] for k in STATS}, cold)


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_warm_equals_cold_bit_for_bit(mode):
    _, _, (warm_lg, warm_tok), _, (cold_lg, cold_tok) = _runs(mode)
    assert warm_tok == cold_tok
    for step, (a, b) in enumerate(zip(warm_lg, cold_lg)):
        assert np.array_equal(a, b), (mode, step)


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_prefix_cache_matches_reference_engine(mode):
    (ref_lg, ref_tok), ref_stats, (lg, tok), stats, _ = _runs(mode)
    assert stats == ref_stats
    # hit at 8 tokens: 2 outer pages + 1 middle page shared; the rings wrap
    # onto shared pages and COW in both slots, once the entry is evicted
    assert stats == {"hits": 1, "misses": 1, "tokens_skipped": 8,
                     "pages_shared": 3, "cow_copies": 4, "evictions": 1}
    assert tok == ref_tok
    for step, (a, b) in enumerate(zip(lg, ref_lg)):
        err = float(np.max(np.abs(a - np.asarray(b))))
        assert err < ATOL, (mode, step, err)


def test_free_and_reinsert_leave_the_sharer_unchanged():
    """Slot 1 shares slot 0's prefix; slot 0 is freed after 2 steps and a
    third prompt with the same first 8 tokens goes into it (a hit on the
    entry that outlived its last sharer). Slot 1 decodes exactly as with
    no prefix cache."""
    _, pc, _, model, tokens = _setup("pp")
    third = tokens[2, :10].copy()
    third[:8] = tokens[0, :8]

    def run(prefix_cache):
        eng = SOIEngine(pc, device="cpu", prefix_cache=prefix_cache, **KW)
        ds = eng.init_decode_state(model)
        for slot in (0, 1):
            ds = eng.insert(eng.prefill(model, torch.from_numpy(
                tokens[slot, :12])), ds, slot)
        out = []
        for step in range(4):
            if step == 2:
                ds = eng.free_slot(ds, 0)
                ds = eng.insert(eng.prefill(model, torch.from_numpy(third)),
                                ds, 0)
            ds, res = eng.generate(model, ds)
            out.append(res.logits[1].clone())
        return out, eng.prefix_cache_stats

    warm, stats = run(True)
    cold, _ = run(False)
    for a, b in zip(warm, cold):
        assert torch.equal(a, b)
    assert stats["hits"] == 2 and stats["misses"] == 1
