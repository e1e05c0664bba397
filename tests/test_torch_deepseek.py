"""deepseek-v2 serving of repro_torch on the CPU: MLA attention and MoE
blocks on the SOI engine, against the JAX engine on the same weights.

The smoke config (5 layers: a dense layer 0, then MoE; 8 routed experts
top-2 + 1 shared; MLA with q_lora 32, kv_lora 24) in float32, weights from
the JAX ``init`` through ``from_jax_params``. Four slots (so every decode
token is a dispatch group of its own and no slot's routing depends on
another's), prompts of 11 and 12 tokens from the start and one of 9 after
2 steps, 8 greedy steps:

  * pp and fp, dense rings and paged pools (page 8): the port's greedy
    tokens equal the JAX ``SOIEngine``'s and its logits agree within 5e-4
    at every step (the JAX engine runs dense: its own tests hold its paged
    layout bit for bit to its dense one);
  * the paged engine's logits equal the dense engine's bit for bit;
  * MoE configs prefill at the exact length: an explicit ``prefill_chunk``
    raises, as in the reference, and so do the serving driver's
    ``--chunk-size`` and ``--prefix-cache``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.deepseek_v2_236b as JDS
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import transformer as JT
from repro_torch.configs import deepseek_v2_236b as PDS
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine
from repro_torch.launch import serve as pserve
from repro_torch.models import decode as D

torch.set_num_threads(1)

S = 32
ATOL = 5e-4


@functools.lru_cache(maxsize=None)
def _setup(mode):
    jc = dataclasses.replace(JDS.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(PDS.smoke_config(soi=mode), dtype="float32")
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                            device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (3, 12)).astype(np.int32)
    return jc, pc, jparams, model, tokens


def _greedy(eng, params, tokens, conv, n_steps=8):
    """Prompts of 11 and 12 tokens in slots 0 and 1, one of 9 in slot 2
    after 2 steps; greedy. Returns per step (logits of the active slots as
    numpy, their tokens)."""
    ds = eng.init_decode_state(params)
    active = []
    for slot, n in ((0, 11), (1, 12)):
        ds = eng.insert(eng.prefill(params, conv(tokens[slot, :n])), ds, slot)
        active.append(slot)
    out = []
    for k in range(n_steps):
        if k == 2:
            ds = eng.insert(eng.prefill(params, conv(tokens[2, :9])), ds, 2)
            active.append(2)
        ds, res = eng.generate(params, ds)
        data = np.asarray(res.convert_to_numpy().data)
        out.append((np.asarray(res.logits)[active],
                    [int(data[s, 0]) for s in active]))
    return out


KW = dict(max_concurrent_decodes=4, max_len=S)


@functools.lru_cache(maxsize=None)
def _reference(mode):
    jc, _, jparams, _, tokens = _setup(mode)
    return _greedy(JEngine(jc, **KW), jparams, tokens, jnp.asarray)


@functools.lru_cache(maxsize=None)
def _runs(mode, paged):
    _, pc, _, model, tokens = _setup(mode)
    kw = dict(KW, paged=True, page_size=8) if paged else KW
    return _greedy(SOIEngine(pc, device="cpu", **kw), model, tokens,
                   torch.from_numpy)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_engine_matches_reference_engine(mode, paged):
    ref, got = _reference(mode), _runs(mode, paged)
    for step, ((rl, rt), (gl, gt)) in enumerate(zip(ref, got)):
        assert gt == rt, (mode, paged, step)
        err = float(np.max(np.abs(gl - rl)))
        assert err < ATOL, (mode, paged, step, err)


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_paged_engine_bit_exact_vs_dense_engine(mode):
    dense, paged = _runs(mode, False), _runs(mode, True)
    for step, ((dl, dt), (pl, pt)) in enumerate(zip(dense, paged)):
        assert dt == pt, (mode, step)
        assert np.array_equal(dl, pl), (mode, step)


def test_moe_configs_refuse_chunked_prefill():
    _, pc, _, model, tokens = _setup("pp")
    assert not D.supports_masked_prefill(pc)
    with pytest.raises(ValueError, match="chunked prefill is unsupported"):
        SOIEngine(pc, device="cpu", max_len=S, prefill_chunk=4)
    state = D.init_decode_state(model, pc, 1, S)
    with pytest.raises(NotImplementedError, match="cannot mask pad"):
        D.prefill_chunk(model, pc, state, torch.from_numpy(tokens[:1, :4]),
                        0, 4)
    # the default "pow2" buckets fall back to the exact length, silently
    eng = SOIEngine(pc, device="cpu", max_len=S)
    assert eng.prefill(model, torch.from_numpy(tokens[0, :5])).length == 5


def test_serve_driver_runs_deepseek_smoke_on_cpu():
    argv = ["--arch", "deepseek-v2-236b", "--smoke", "--soi", "pp",
            "--device", "cpu", "--batch", "2", "--prompt-len", "13",
            "--gen-len", "3", "--paged", "--page-size", "4"]
    seqs = pserve.main(argv)
    assert seqs.shape == (2, 3)
    assert ((seqs >= 0) & (seqs < PDS.smoke_config().vocab)).all()
    with pytest.raises(ValueError, match="chunked prefill is unsupported"):
        pserve.main(argv + ["--chunk-size", "4"])
    with pytest.raises(ValueError, match="prefill_chunk"):
        pserve.main(argv + ["--prefix-cache"])
