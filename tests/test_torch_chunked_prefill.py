"""Chunked prefill of repro_torch against the JAX reference on the CPU.

  * ``models.decode.prefill_chunk``: logits and the whole state (caches,
    clock, SOI conv window and queue) after every chunk equal the
    reference's at 5e-4 (f32), for a true length that ends mid-chunk and
    mid-window, plain and SOI pp/fp — the SOI compress, conv carry, queue
    and fp shift across chunks;
  * ``attention._chunk_cache_merge`` (in place, slice copies) equals the
    reference's gather-based merge on a ring that wraps;
  * the engine with chunked prefill on dense rings gives the reference
    engine's greedy tokens.
Sizes: qwen3 smoke config in float32 (4 layers, d=64, 4/2 heads).
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
from repro.models import attention as JA
from repro.models import decode as JD
from repro.models import transformer as JT
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine
from repro_torch.models import attention as PA
from repro_torch.models import decode as PD

torch.set_num_threads(1)

S = 16
C = 4
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
        0, jc.vocab, (3, S)).astype(np.int32)
    return jc, pc, jparams, model, tokens


def _groups(cfg):
    return ("segments",) if cfg.soi is None else ("pre", "mid", "post")


def _layers(jgroup):
    """The reference's scanned caches as per-layer numpy dicts."""
    out = []
    for seg in jgroup:
        a = seg["sub0"]["attn"]
        out += [{k: np.asarray(v[i]) for k, v in a.items()}
                for i in range(a["pos"].shape[0])]
    return out


def _assert_state_close(js, ps, cfg, where):
    np.testing.assert_array_equal(ps["t"].numpy(), np.asarray(js["t"]),
                                  err_msg=where)
    for g in _groups(cfg):
        jl = _layers(js[g])
        assert len(jl) == len(ps[g])
        for i, (jc, pc) in enumerate(zip(jl, ps[g])):
            np.testing.assert_array_equal(pc["pos"].numpy(), jc["pos"],
                                          err_msg=f"{where} {g}[{i}]")
            for name in ("k", "v"):
                np.testing.assert_allclose(pc[name].numpy(), jc[name],
                                           atol=ATOL, rtol=0,
                                           err_msg=f"{where} {g}[{i}]")
    if cfg.soi is not None:
        for name in ("conv_buf", "queue"):
            np.testing.assert_allclose(ps[name].numpy(),
                                       np.asarray(js[name]), atol=ATOL,
                                       rtol=0, err_msg=f"{where} {name}")


@pytest.mark.parametrize("mode", [None, "pp", "fp"])
def test_prefill_chunk_matches_reference(mode):
    """True length 11: the last chunk [8, 12) holds 3 real rows and ends
    mid-window (11 % 2 = 1), so its last frame is partial."""
    jc, pc, jparams, model, tokens = _setup(mode)
    jchunk = jax.jit(lambda p, st, tk, off, tl: JD.prefill_chunk(
        p, jc, st, tk, off, tl))
    tl = 11
    toks = np.pad(tokens[:1, :tl], ((0, 0), (0, 12 - tl)))
    js = JD.init_decode_state(jparams, jc, 1, max_len=S)
    ps = PD.init_decode_state(model, pc, 1, max_len=S)
    for i in range(3):
        chunk = toks[:, i * C:(i + 1) * C]
        jl, js = jchunk(jparams, js, jnp.asarray(chunk),
                        jnp.asarray(i * C, jnp.int32),
                        jnp.asarray(tl, jnp.int32))
        pl, ps = PD.prefill_chunk(model, pc, ps, torch.from_numpy(chunk),
                                  i * C, tl)
        where = f"{mode} chunk {i}"
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=where)
        _assert_state_close(js, ps, pc, where)


@pytest.mark.parametrize("offset,end", [(0, 4), (4, 8), (8, 12), (12, 15)])
def test_chunk_cache_merge_wrapping_ring_matches_reference(offset, end):
    """A ring of 6 rows taking chunks of 4: the chunk's rows wrap around
    the ring's end, and pad rows (at or past ``end``) keep the old
    contents."""
    rng = np.random.default_rng(offset)
    s_cache, c = 6, 4
    k_old = rng.standard_normal((1, s_cache, 2, 8)).astype(np.float32)
    pos_old = np.arange(s_cache, dtype=np.int32)[None] + offset - s_cache
    k_new = rng.standard_normal((1, c, 2, 8)).astype(np.float32)
    want = JA._chunk_cache_merge({"k": jnp.asarray(k_old),
                                  "pos": jnp.asarray(pos_old)}, offset, end,
                                 k=jnp.asarray(k_new))
    got = {"k": torch.from_numpy(k_old.copy()),
           "pos": torch.from_numpy(pos_old.copy())}
    PA._chunk_cache_merge(got, offset, end, k=torch.from_numpy(k_new))
    assert np.array_equal(got["k"].numpy(), np.asarray(want["k"]))
    assert np.array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


def _greedy(engine, params, prompts, to_dev, n_steps=6):
    ds = engine.init_decode_state(params)
    toks = {}
    for slot, p in enumerate(prompts):
        prefix = engine.prefill(params, to_dev(p))
        toks[slot] = [int(np.asarray(prefix.first_token)[0])]
        ds = engine.insert(prefix, ds, slot)
    for _ in range(n_steps):
        ds, res = engine.generate(params, ds)
        data = np.asarray(res.convert_to_numpy().data)
        for slot in toks:
            toks[slot].append(int(data[slot, 0]))
    return toks


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_chunked_engine_matches_reference_engine(mode):
    jc, pc, jparams, model, tokens = _setup(mode)
    prompts = [tokens[0, :9], tokens[1, :6], tokens[2, :4]]
    kw = dict(max_concurrent_decodes=3, max_len=S, prefill_chunk=C)
    ref = _greedy(JEngine(jc, **kw), jparams, prompts, jnp.asarray)
    got = _greedy(SOIEngine(pc, device="cpu", **kw), model, prompts,
                  torch.from_numpy)
    assert got == ref
