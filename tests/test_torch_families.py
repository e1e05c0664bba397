"""Four more LM families on repro_torch, on the CPU, against the JAX package
on the same weights: olmoe-1b-7b (MoE, qk_norm), h2o-danube-1.8b (window
rings), nemotron-4-15b (LayerNorm, squared-ReLU MLP, partial rotary) and
mistral-large-123b (rope_theta 1e6), each at its ``smoke_config`` in
float32, weights from the JAX ``init`` through ``from_jax_params``:

  * the configs equal the reference's, and ``n_layers`` cuts the depth
    only;
  * the port's forward equals ``repro.models.transformer.forward`` within
    1e-4, pp and fp;
  * the port's ``SOIEngine`` against the JAX ``SOIEngine``, dense and
    paged (pages of 4), pp and fp: prompts of 11 and 12 tokens from the
    start and one of 9 after 3 steps (mixed SOI phases), 10 greedy steps,
    max_len 32 (danube's window-8 rings wrap) — greedy tokens identical,
    logits within 5e-4 at every step; 4 slots, so no MoE dispatch group of
    olmoe's can overflow (ROADMAP.md Queue 3); the paged engine equals the
    dense one bit for bit;
  * danube through a paged, chunked prefix-cache engine whose window rings
    wrap onto shared pages: counters, tokens and logits as the reference's,
    and warm equal to cold bit for bit;
  * a danube smoke config at 12 query heads over one KV head of 80 (the
    decode reads' new G and dh at small width) through both engines;
  * the serving driver on each family, dense equal to paged.

The new pieces alone (LayerNorm, the plain MLPs, the weight bridge,
``check_trainable``) are in tests/test_torch_norm_mlp.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.h2o_danube_1_8b as JDN
import repro.configs.mistral_large_123b as JMS
import repro.configs.nemotron_4_15b as JNM
import repro.configs.olmoe_1b_7b as JOL
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import transformer as JT
from repro_torch import configs as pconfigs
from repro_torch.configs import h2o_danube_1_8b as PDN
from repro_torch.configs import mistral_large_123b as PMS
from repro_torch.configs import nemotron_4_15b as PNM
from repro_torch.configs import olmoe_1b_7b as POL
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine
from repro_torch.launch import serve as pserve
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

S = 32
ATOL = 5e-4             # port vs JAX engine (PERF.md §2)
FWD_ATOL = 1e-4         # port vs JAX forward (tests/test_torch_model.py)
FAMILIES = {"olmoe-1b-7b": (JOL, POL), "h2o-danube-1.8b": (JDN, PDN),
            "nemotron-4-15b": (JNM, PNM), "mistral-large-123b": (JMS, PMS)}
STATS = ("hits", "misses", "tokens_skipped", "pages_shared", "cow_copies",
         "evictions")


def _g12_dh80(cfg):
    """danube's smoke config at 12 query heads over one KV head of 80."""
    seg = cfg.segments[0]
    b = seg.blocks[0]
    attn = dataclasses.replace(b.attn, n_heads=12, n_kv=1, head_dim=80)
    return dataclasses.replace(cfg, segments=(dataclasses.replace(
        seg, blocks=(dataclasses.replace(b, attn=attn),)),))


@functools.lru_cache(maxsize=None)
def _setup(arch, mode):
    """(JAX config, port config, JAX params, port model, tokens); arch
    ``g12-dh80`` is ``_g12_dh80`` of danube's smoke config."""
    jm, pm = FAMILIES.get(arch, FAMILIES["h2o-danube-1.8b"])
    jc = dataclasses.replace(jm.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(pm.smoke_config(soi=mode), dtype="float32")
    if arch == "g12-dh80":
        jc, pc = _g12_dh80(jc), _g12_dh80(pc)
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                            device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (3, 16)).astype(np.int32)
    return jc, pc, jparams, model, tokens


def _greedy(eng, params, tokens, conv, n_steps=10):
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


KW = dict(max_concurrent_decodes=4, max_len=S)
PAGED = dict(paged=True, page_size=4)


@functools.lru_cache(maxsize=None)
def _reference(arch, mode, paged):
    jc, _, jparams, _, tokens = _setup(arch, mode)
    kw = dict(KW, **PAGED) if paged else KW
    return _greedy(JEngine(jc, **kw), jparams, tokens, jnp.asarray)


@functools.lru_cache(maxsize=None)
def _runs(arch, mode, paged):
    _, pc, _, model, tokens = _setup(arch, mode)
    kw = dict(KW, **PAGED) if paged else KW
    return _greedy(SOIEngine(pc, device="cpu", **kw), model, tokens,
                   torch.from_numpy)


def _match(ref, got, label):
    for step, ((rl, rt), (gl, gt)) in enumerate(zip(ref, got)):
        assert gt == rt, (label, step)
        err = float(np.max(np.abs(gl - rl)))
        assert err < ATOL, (label, step, err)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_configs_match_reference_and_cut_depth_only(arch):
    jm, pm = FAMILIES[arch]
    for soi in (None, "pp", "fp"):
        assert (dataclasses.asdict(pm.config(soi=soi))
                == dataclasses.asdict(jm.config(soi=soi)))
        assert (dataclasses.asdict(pm.smoke_config(soi=soi))
                == dataclasses.asdict(jm.smoke_config(soi=soi)))
    full = pconfigs.get(arch, soi="pp")
    cut = pconfigs.get(arch, soi="pp", n_layers=8)
    assert cut.n_layers == 8 and (cut.soi.first_layer,
                                  cut.soi.last_layer) == (2, 6)
    assert (cut.d_model, cut.vocab, cut.segments[0].blocks) == (
        full.d_model, full.vocab, full.segments[0].blocks)
    assert arch in pconfigs.ARCHS


@pytest.mark.parametrize("mode", ["pp", "fp"])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_forward_matches_reference(arch, mode):
    jc, pc, jparams, model, tokens = _setup(arch, mode)
    ref = np.asarray(jax.jit(lambda p, t: JT.forward(p, jc, t))(
        jparams, jnp.asarray(tokens)))
    got = PT.forward(model, pc, torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (3, 16, jc.vocab)
    err = float(np.max(np.abs(got - ref)))
    assert err < FWD_ATOL, (arch, mode, err)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch,mode", [(a, m) for a in sorted(FAMILIES)
                                       for m in ("pp", "fp")]
                         + [("g12-dh80", "pp")])
def test_engine_matches_reference_engine(arch, mode, paged):
    _match(_reference(arch, mode, paged), _runs(arch, mode, paged),
           (arch, mode, paged))


@pytest.mark.parametrize("mode", ["pp", "fp"])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_paged_engine_bit_exact_vs_dense_engine(arch, mode):
    dense, paged = _runs(arch, mode, False), _runs(arch, mode, True)
    for step, ((dl, dt), (pl, pt)) in enumerate(zip(dense, paged)):
        assert dt == pt, (arch, mode, step)
        assert np.array_equal(dl, pl), (arch, mode, step)


PC_KW = dict(max_concurrent_decodes=2, max_len=16, paged=True, page_size=4,
             prefill_chunk=4)


def _prefix_greedy(eng, params, prompts, conv, n_steps=10):
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


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_danube_prefix_cache_on_wrapping_windows_matches_reference(mode):
    """A prompt of 8 tokens (it fills the window-8 ring, so the index
    keeps it) and one of 12 that shares them, through pages of 4 and chunks
    of 4: the second hits at 8 and wraps its ring during prefill, and both
    rings wrap in decode onto pages the index shares, so they copy on
    write."""
    jc, pc, jparams, model, tokens = _setup("h2o-danube-1.8b", mode)
    prompts = [tokens[0, :8].copy(), tokens[1, :12].copy()]
    prompts[1][:8] = prompts[0]
    jeng = JEngine(jc, prefix_cache=True, **PC_KW)
    rl, rt = _prefix_greedy(jeng, jparams, prompts, jnp.asarray)
    warm_eng = SOIEngine(pc, device="cpu", prefix_cache=True, **PC_KW)
    wl, wt = _prefix_greedy(warm_eng, model, prompts, torch.from_numpy)
    cl, ct = _prefix_greedy(SOIEngine(pc, device="cpu", **PC_KW), model,
                            prompts, torch.from_numpy)
    stats = {k: warm_eng.prefix_cache_stats[k] for k in STATS}
    assert stats == {k: jeng.prefix_cache_stats[k] for k in STATS}
    assert stats["hits"] == 1 and stats["cow_copies"] > 0, stats
    assert wt == rt == ct
    for step, (a, b, c) in enumerate(zip(wl, rl, cl)):
        assert np.array_equal(a, c), (mode, step)
        assert float(np.max(np.abs(a - np.asarray(b)))) < ATOL, (mode, step)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_serve_driver_runs_each_family_on_cpu(arch):
    argv = ["--arch", arch, "--smoke", "--soi", "pp", "--device", "cpu",
            "--batch", "3", "--prompt-len", "14", "--stagger", "1",
            "--gen-len", "6"]
    dense = pserve.main(argv)
    paged = pserve.main(argv + ["--paged", "--page-size", "2"])
    assert dense.shape == (3, 6) and np.array_equal(dense, paged)
