"""Bucketed and chunked prefill and the copy-on-write prefix cache of
repro_torch on an MLA stack with a dense MLP (the ``mla-test``
configuration of tests/test_prefix_cache.py: 2 layers, d_model 32, 4
heads, q_lora 16, kv_lora 16, qk_nope 16, qk_rope 8, v_head 16, SwiGLU
64), on the CPU. Such a stack can mask pad, unlike deepseek-v2's MoE
blocks, so it takes the bucketed and the chunked prefill paths.

Two 12-token prompts sharing their first 8 tokens go through a paged,
chunked engine (max_len 16, page size 4, chunk 4) and decode 10 greedy
steps, so both rings wrap at position 16 onto pages the prefix index
still shares and copy them on write (the latent, rope and position pools):

  * warm (prefix cache on) equals cold (off) bit for bit, logits and
    tokens;
  * the prefix-cache counters equal the JAX engine's on the same
    schedule, and the logits agree with it within 5e-4 (same tokens).

A dense engine with the default power-of-two prefill buckets gives the
JAX engine's greedy tokens, logits within 5e-4.

Weights come from the JAX ``init`` through ``from_jax_params``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as JB
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import transformer as JT
from repro_torch.configs import base as PB
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine

torch.set_num_threads(1)

S = 16
ATOL = 5e-4
KW = dict(max_concurrent_decodes=2, max_len=S, paged=True, page_size=4,
          prefill_chunk=4)
STATS = ("hits", "misses", "tokens_skipped", "pages_shared", "cow_copies",
         "evictions")


def _mla_cfg(B):
    mla = B.AttnCfg(kind="mla", n_heads=4, n_kv=4, head_dim=0, q_lora=16,
                    kv_lora=16, qk_nope=16, qk_rope=8, v_head=16)
    blk = B.BlockCfg(attn=mla, mlp=B.MLPCfg(kind="swiglu", d_ff=64))
    return B.ModelCfg(name="mla-test", d_model=32, vocab=128,
                      segments=(B.Segment(blocks=(blk,), n_layers=2),),
                      tie_embeddings=True, dtype="float32")


def _greedy(eng, params, prompts, conv, n_steps=10):
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
def _setup():
    jc, pc = _mla_cfg(JB), _mla_cfg(PB)
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                            device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (2, 12)).astype(np.int32)
    tokens[1, :8] = tokens[0, :8]
    return jc, pc, jparams, model, tokens


@functools.lru_cache(maxsize=None)
def _runs():
    jc, pc, jparams, model, tokens = _setup()
    prompts = [tokens[0], tokens[1]]
    jeng = JEngine(jc, prefix_cache=True, **KW)
    ref = _greedy(jeng, jparams, prompts, jnp.asarray)
    warm_eng = SOIEngine(pc, device="cpu", prefix_cache=True, **KW)
    warm = _greedy(warm_eng, model, prompts, torch.from_numpy)
    cold = _greedy(SOIEngine(pc, device="cpu", **KW), model, prompts,
                   torch.from_numpy)
    return (ref, {k: jeng.prefix_cache_stats[k] for k in STATS}, warm,
            {k: warm_eng.prefix_cache_stats[k] for k in STATS}, cold)


def test_mla_warm_equals_cold_bit_for_bit():
    _, _, (warm_lg, warm_tok), stats, (cold_lg, cold_tok) = _runs()
    assert stats["cow_copies"] > 0 and stats["hits"] == 1
    assert warm_tok == cold_tok
    for step, (a, b) in enumerate(zip(warm_lg, cold_lg)):
        assert np.array_equal(a, b), step


def test_mla_prefix_cache_matches_reference_engine():
    (ref_lg, ref_tok), ref_stats, (lg, tok), stats, _ = _runs()
    assert stats == ref_stats
    assert tok == ref_tok
    for step, (a, b) in enumerate(zip(lg, ref_lg)):
        err = float(np.max(np.abs(a - np.asarray(b))))
        assert err < ATOL, (step, err)


def test_mla_bucketed_prefill_matches_reference_engine():
    """Prompts of 11 and 9 tokens pad to the 16-token bucket."""
    jc, pc, jparams, model, tokens = _setup()
    prompts = [tokens[0, :11], tokens[1, :9]]
    kw = dict(max_concurrent_decodes=2, max_len=S)
    ref_lg, ref_tok = _greedy(JEngine(jc, **kw), jparams, prompts,
                              jnp.asarray, n_steps=4)
    eng = SOIEngine(pc, device="cpu", **kw)
    assert eng._buckets == (S,)
    lg, tok = _greedy(eng, model, prompts, torch.from_numpy, n_steps=4)
    assert tok == ref_tok
    for step, (a, b) in enumerate(zip(lg, ref_lg)):
        err = float(np.max(np.abs(a - np.asarray(b))))
        assert err < ATOL, (step, err)
