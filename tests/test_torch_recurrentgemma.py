"""recurrentgemma serving of repro_torch on the CPU: RG-LRU and windowed MQA
blocks on the SOI engine, against the JAX package on the same weights.

The smoke config (6 layers: 2 x (RG-LRU, RG-LRU, local attention); d 64,
MQA 4 heads of 16 over one KV head, window 8; SOI over layers 0..3, so the
pre part is empty) in float32, weights from the JAX ``init`` through
``from_jax_params``:

  * scattered decode through ``generate_step`` equals the port's offline
    forward, in pp and fp (the reference's
    ``test_scattered_decode_equals_offline``), within 5e-4 as there;
  * the port's ``SOIEngine`` against the JAX ``SOIEngine`` (dense, and
    paged with pages of 4): prompts of 11 and 12 tokens from the start and
    one of 9 after 3 steps, so slots sit at mixed SOI phases, 14 greedy
    steps with max_len 32, so every window-8 ring wraps — greedy tokens
    identical, logits within 5e-4 at every step;
  * the port's paged engine equals its dense engine bit for bit;
  * ``from_jax_params`` carries the 3-block scanned tree (``sub0..sub2``)
    and the trailing RG-LRU segment across leaf for leaf; the configs
    equal the reference's, and ``n_layers`` cuts the depth by patterns;
  * the serving driver runs the smoke config and refuses chunked prefill
    and the prefix cache, as the reference's engine does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.recurrentgemma_9b as JRG
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import transformer as JT
from repro_torch.configs import recurrentgemma_9b as PRG
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine
from repro_torch.engine.step import generate_step
from repro_torch.launch import serve as pserve
from repro_torch.models import decode as PD
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

S = 32
ATOL = 5e-4


@functools.lru_cache(maxsize=None)
def _setup(mode):
    jc = dataclasses.replace(JRG.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(PRG.smoke_config(soi=mode), dtype="float32")
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                            device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (3, 16)).astype(np.int32)
    return jc, pc, jparams, model, tokens


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_scattered_decode_equals_offline(mode):
    _, pc, _, model, tokens = _setup(mode)
    toks = torch.from_numpy(tokens[:2])
    full = PT.forward(model, pc, toks)
    state = PD.init_decode_state(model, pc, 2, max_len=16)
    for t in range(16):
        lg, state = generate_step(model, pc, state, toks[:, t])
        err = float((lg - full[:, t]).abs().max())
        assert err < ATOL, (mode, t, err)


def _greedy(eng, params, tokens, conv, n_steps=14):
    """Prompts of 11 and 12 tokens in slots 0 and 1, one of 9 in slot 2
    after 3 steps; greedy. Returns per step (logits of the active slots as
    numpy, their tokens)."""
    ds = eng.init_decode_state(params)
    active = []
    for slot, n in ((0, 11), (1, 12)):
        ds = eng.insert(eng.prefill(params, conv(tokens[slot, :n])), ds, slot)
        active.append(slot)
    out = []
    for k in range(n_steps):
        if k == 3:
            ds = eng.insert(eng.prefill(params, conv(tokens[2, :9])), ds, 2)
            active.append(2)
        ds, res = eng.generate(params, ds)
        data = np.asarray(res.convert_to_numpy().data)
        out.append((np.asarray(res.logits)[active],
                    [int(data[s, 0]) for s in active]))
    return out


KW = dict(max_concurrent_decodes=3, max_len=S)
PAGED = dict(paged=True, page_size=4)


@functools.lru_cache(maxsize=None)
def _reference(mode, paged):
    jc, _, jparams, _, tokens = _setup(mode)
    kw = dict(KW, **PAGED) if paged else KW
    return _greedy(JEngine(jc, **kw), jparams, tokens, jnp.asarray)


@functools.lru_cache(maxsize=None)
def _runs(mode, paged):
    _, pc, _, model, tokens = _setup(mode)
    kw = dict(KW, **PAGED) if paged else KW
    return _greedy(SOIEngine(pc, device="cpu", **kw), model, tokens,
                   torch.from_numpy)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_engine_matches_reference_engine(mode, paged):
    ref, got = _reference(mode, paged), _runs(mode, paged)
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


def test_from_jax_params_unstacks_the_scanned_pattern():
    jc = dataclasses.replace(JRG.smoke_config(soi="pp"), dtype="float32")
    # 7 layers: two (rec, rec, attn) groups and one trailing RG-LRU layer
    jc = dataclasses.replace(jc, segments=jc.segments + (dataclasses.replace(
        jc.segments[0], blocks=jc.segments[0].blocks[:1], n_layers=1),))
    pc = dataclasses.replace(
        PRG.smoke_config(soi="pp"), dtype="float32",
        segments=PRG._cfg(2, 1, 64, 4, 16, 160, 256, 8, 4).segments)
    jp, _ = split_axes(JT.init(jax.random.PRNGKey(2), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jp), pc, device="cpu")
    assert len(model.blocks) == 7
    for i, bp in enumerate(model.blocks):
        seg, g, sub = (0, i // 3, i % 3) if i < 6 else (1, 0, 0)
        tree = jax.tree.map(lambda x: np.asarray(x)[g],
                            jp["segments"][seg][f"sub{sub}"])
        mixer = "attn" if sub == 2 and seg == 0 else "rglru"
        assert hasattr(bp, mixer) and bp.bcfg.mlp.kind == "geglu"
        for name, leaf in tree[mixer].items():
            assert np.array_equal(getattr(bp, mixer).get_parameter(
                name).detach().numpy(), leaf), (i, name)
        for name in ("ln1", "ln2"):
            assert np.array_equal(getattr(bp, name).detach().numpy(),
                                  tree[name]["scale"]), (i, name)


def test_configs_match_reference_and_cut_by_patterns():
    for soi in (None, "pp"):
        assert (dataclasses.asdict(PRG.config(soi=soi))
                == dataclasses.asdict(JRG.config(soi=soi)))
        assert (dataclasses.asdict(PRG.smoke_config(soi=soi))
                == dataclasses.asdict(JRG.smoke_config(soi=soi)))
    full = PRG.config(soi="pp")
    blocks = PT.layer_blocks(full)
    assert len(blocks) == 38
    assert sum(b.rglru is not None for b in blocks) == 26
    assert (full.soi.first_layer, full.soi.last_layer) == (9, 27)
    pre, mid, post = PT.soi_partition(full)
    assert [sum(s.n_layers for s in p) for p in (pre, mid, post)] == [9, 18,
                                                                      11]
    cut = PRG.config(soi="pp", n_layers=12)
    assert [s.n_layers for s in cut.segments] == [12]
    assert (cut.soi.first_layer, cut.soi.last_layer) == (3, 9)
    assert cut.d_model == 4096 and cut.vocab == 256000
    assert PRG.smoke_config(soi="pp").soi.first_layer == 0


def test_serve_driver_runs_recurrentgemma_smoke_on_cpu():
    argv = ["--arch", "recurrentgemma-9b", "--smoke", "--soi", "pp",
            "--device", "cpu", "--batch", "3", "--prompt-len", "13",
            "--stagger", "1", "--gen-len", "6"]
    dense = pserve.main(argv)
    paged = pserve.main(argv + ["--paged", "--page-size", "4"])
    assert dense.shape == (3, 6) and np.array_equal(dense, paged)
    with pytest.raises(ValueError, match="chunked prefill is unsupported"):
        pserve.main(argv + ["--chunk-size", "4"])
    with pytest.raises(ValueError, match="prefill_chunk"):
        pserve.main(argv + ["--paged", "--page-size", "4",
                            "--prefix-cache"])
