"""The captured step graphs of repro_torch on the card (marker ``gpu``), at
smoke width:

  * ``SOIEngine.generate`` — one CUDA graph per SOI branch, replayed over
    the live decode state — against an eager twin (a deep copy of the
    engine and its state taken before the first step, whose step runs
    ``soi_engine.gen_step`` eagerly) bit for bit: tokens, logits and every
    leaf of the decode state (the pools outside their null page), over
    2 × stride + 5 steps with a late insert,
    SOI pp and fp, dense rings and paged pools with chunked prefill and the
    prefix cache (rings wrapping, so COW flushes run between replays);
    float32 and bfloat16;
  * two captures for an SOI engine, none again in steady state; the kernel
    launches counted from replays as the host clocks predict;
  * a rebound state leaf raises ``DroppedDonationError`` and other params
    ``ValueError`` before any replay;
  * the U-Net session's phase graphs against the eager steppers, bit for
    bit, with ``stmc_conv`` launches equal to the phase plans';
  * ``SOIEngine(speculate=K)``'s window graphs (draft, restore and verify
    in one graph a window key) against an eager twin running
    ``soi_engine.spec_step``, bit for bit, for pp/fp, dense and paged with
    the prefix cache, f32/bf16, K 2 and 4, a slot opted out; captures equal
    to the distinct window keys, and the decode reads launched a replay as
    the key's plan gives them; a rejection forced at every depth on the
    card leaves the state of the sequential steps bit for bit; a rebound
    state leaf still raises ``DroppedDonationError``.

Without a CUDA device every test here skips (decided inside the ``cuda``
fixture, so every worker collects the same tests). On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py

(``--noconftest``: tests/conftest.py manages JAX, which the card's machine
does not have; this file imports no JAX.)
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.core.soi import SOIConvCfg
from repro_torch.engine import SOIEngine
from repro_torch.engine import soi_engine as SE
from repro_torch.engine.contracts import DroppedDonationError, state_leaves
from repro_torch.engine.session import unet_stream_session
from repro_torch.engine.speculative import verify_commit
from repro_torch.engine.step import generate_step
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models import unet as U

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

S = 32
# the leaves of an attention cache: in a paged state, pools whose row 0 is
# the null page
POOL_LEAVES = ("['k']", "['v']", "['pos']", "['latent']", "['rope']")
LAYOUTS = {"dense": dict(max_concurrent_decodes=3, max_len=S),
           "paged-prefix": dict(max_concurrent_decodes=3, max_len=S,
                                paged=True, page_size=4, prefill_chunk=4,
                                prefix_cache=True)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _eager_twin(engine, ds):
    """A deep copy of ``engine`` (host tables, prefix index) and its live
    state ``ds``, whose step runs ``gen_step`` eagerly."""
    twin, twin_ds = copy.deepcopy((engine, ds))
    cfg = twin.cfg
    twin.graph = lambda params, d, mid: SE.gen_step(params, cfg, d, mid)
    return twin, twin_ds


def _prompts(cfg, seed):
    """Slots 0 and 1 in one SOI phase class, and slot 2 in theirs when it
    comes in after 3 steps, so steps alternate between the two branches;
    slot 1 shares slot 0's first 8 tokens (a prefix-cache hit)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (3, 28)).astype(np.int32)
    toks[1, :8] = toks[0, :8]
    return [toks[0, :28], toks[1, :26], toks[2, :15]]


def _graph_vs_eager(engine, params, prompts, n_steps, late_at, dev):
    ds = engine.init_decode_state(params)
    for slot in (0, 1):
        ds = engine.insert(engine.prefill(params, torch.from_numpy(
            prompts[slot]).to(dev)), ds, slot)
    twin, tds = _eager_twin(engine, ds)
    for k in range(n_steps):
        if k == late_at:
            prefix = engine.prefill(params,
                                    torch.from_numpy(prompts[2]).to(dev))
            ds = engine.insert(prefix, ds, 2)
            tds = twin.insert(prefix, tds, 2)
        ds, res = engine.generate(params, ds)
        tds, tres = twin.generate(params, tds)
        assert torch.equal(res.logits, tres.logits), k
        assert np.array_equal(res.convert_to_numpy().data,
                              tres.convert_to_numpy().data), k
    for (path, a), (_, b) in zip(state_leaves(ds), state_leaves(tds)):
        if engine._paged and path.startswith("['model']") and path.endswith(
                POOL_LEAVES):
            # the null page takes the writes of slots that must not write,
            # several to one row at once (the scatter picks which lands);
            # every read masks it
            a, b = a[1:], b[1:]
        assert torch.equal(a, b), path
    return ds, twin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_generate_graph_equals_eager(cuda, mode, layout, dtype):
    cfg = dataclasses.replace(PQ.smoke_config(soi=mode), dtype=dtype)
    params = T.cast_params(T.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda), cfg)
    eng = SOIEngine(cfg, device=cuda, **LAYOUTS[layout])
    n_steps = 2 * cfg.soi.stride + 5
    ops.reset_launch_counts()
    _graph_vs_eager(eng, params, _prompts(cfg, 1), n_steps, 3, cuda)
    assert eng.graph.captures == 2            # the middle, and no middle
    assert eng.graph.replays == n_steps - 2
    if layout == "paged-prefix":
        assert eng.prefix_cache_stats["cow_copies"] > 0
        assert eng.cow_flushes > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_replayed_launches_follow_the_host_clocks(cuda, layout):
    cfg = dataclasses.replace(PQ.smoke_config(soi="pp"), dtype="bfloat16")
    params = T.cast_params(T.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda), cfg)
    eng = SOIEngine(cfg, device=cuda, **LAYOUTS[layout])
    ds = eng.init_decode_state(params)
    for slot, p in enumerate(_prompts(cfg, 3)[:2]):
        ds = eng.insert(eng.prefill(params, torch.from_numpy(p).to(cuda)),
                        ds, slot)
    read = ("paged_decode_attention" if layout != "dense"
            else "decode_attention")
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    torch.cuda.synchronize(cuda)
    ops.reset_launch_counts()
    s0, m0 = eng.steps, eng.mid_steps
    for _ in range(9):
        ds, _res = eng.generate(params, ds)
    torch.cuda.synchronize(cuda)
    steps, mids = eng.steps - s0, eng.mid_steps - m0
    counts = ops.launch_counts()
    assert counts[read] == n_outer * steps + n_mid * mids
    assert eng.graph.captures == 2 and eng.graph.replays == steps - 2
    for (mid,), st in eng.graph.stats().items():
        assert st["launches"][read] == n_outer + (n_mid if mid else 0)
        assert st["capture_s"] > 0


def test_rebound_leaf_or_params_raise_before_a_replay(cuda):
    cfg = dataclasses.replace(PQ.smoke_config(soi="pp"), dtype="float32")
    params = T.init(cfg, generator=torch.Generator(device=cuda)
                    .manual_seed(4), device=cuda)
    # rings of 64: a K cache leaf of 3 x 64 x 2 x 16 float32 is 24 KiB
    eng = SOIEngine(cfg, device=cuda, max_concurrent_decodes=3, max_len=64)
    ds = eng.init_decode_state(params)
    ds = eng.insert(eng.prefill(params, torch.arange(
        12, dtype=torch.int32, device=cuda)), ds, 0)
    for _ in range(2 * cfg.soi.stride):
        ds, _res = eng.generate(params, ds)
    assert eng.graph.captures == 2
    other = copy.copy(params)                 # another module, same weights
    with pytest.raises(ValueError, match="module"):
        eng.graph(other, ds, True)
    k = ds["model"]["pre"][0]["k"]
    assert k.nbytes >= 16 * 1024
    ds["model"]["pre"][0]["k"] = k.clone()
    with pytest.raises(DroppedDonationError, match=r"\['pre'\]\[0\]\['k'\]"):
        eng.graph(params, ds, True)
    ds["model"]["pre"][0]["k"] = k
    eng.graph(params, ds, True)                # the captured tensors: fine
    with pytest.raises(ValueError, match="module"):
        params.blocks[0].ln1 = torch.nn.Parameter(params.blocks[0].ln1
                                                  .clone())
        eng.graph(params, ds, False)


UNET_KW = dict(in_channels=8, out_channels=8, enc_channels=(6, 8, 10, 12))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("soi", [None, dict(pairs=(2,)), dict(pairs=(1, 3)),
                                 dict(pairs=(1,), mode="fp", shift_pos=3),
                                 dict(pairs=(2,), mode="fp",
                                      extrapolation="tconv")],
                         ids=["none", "pp2", "pp13", "fp1-shift3",
                              "tconv-fp2"])
def test_unet_session_graph_equals_eager(cuda, soi, batch):
    cfg = U.UNetConfig(soi=None if soi is None else SOIConvCfg(**soi),
                       **UNET_KW)
    model = U.init(cfg, generator=torch.Generator(device=cuda)
                   .manual_seed(5), device=cuda)
    n = 3 * cfg.period + 2
    x = torch.randn((batch, n, 8), generator=torch.Generator(device=cuda)
                    .manual_seed(6), device=cuda)
    sess = unet_stream_session(model, cfg, batch=batch, device=cuda)
    ops.reset_launch_counts()
    ys = [sess.push(x[:, t]) for t in range(n)]
    torch.cuda.synchronize(cuda)
    planned = U.convs_per_phase(cfg)
    assert ops.launch_counts()["stmc_conv"] == sum(
        planned[t % cfg.period] for t in range(n))
    assert sess.graph.captures == cfg.period
    assert sess.graph.replays == n - cfg.period
    steppers = U.make_phase_steppers(cfg)
    state = U.init_stream_state(batch, cfg, device=cuda)
    for t in range(n):
        state, y = steppers[t % cfg.period](model, state, x[:, t])
        assert torch.equal(ys[t], y), t
    for (path, a), (_, b) in zip(state_leaves(sess.state["inner"]),
                                 state_leaves(state)):
        assert torch.equal(a, b), path


# -- speculative windows ----------------------------------------------------

def _spec_twin(engine, ds):
    """An eager twin of a speculative engine: its windows run
    ``spec_step`` eagerly."""
    twin, twin_ds = copy.deepcopy((engine, ds))
    cfg = twin.cfg
    twin.spec_graph = lambda params, d, spec, key: SE.spec_step(
        params, cfg, d, spec, key)
    return twin, twin_ds


def _window_reads(cfg, key) -> int:
    """Decode reads one window launches: K-1 draft steps of the outer
    layers, then K verify steps, the middle where the pattern says."""
    k, pattern = key
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    return (2 * k - 1) * n_outer + n_mid * sum(pattern)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_spec_window_graph_equals_eager(cuda, mode, layout, dtype, k):
    cfg = dataclasses.replace(PQ.smoke_config(soi=mode), dtype=dtype)
    params = T.cast_params(T.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda), cfg)
    eng = SOIEngine(cfg, device=cuda, speculate=k, **LAYOUTS[layout])
    prompts = _prompts(cfg, 1)
    ds = eng.init_decode_state(params)
    for slot in (0, 1):
        ds = eng.insert(eng.prefill(params, torch.from_numpy(
            prompts[slot]).to(cuda)), ds, slot, speculate=slot == 0)
    twin, tds = _spec_twin(eng, ds)
    read = ("paged_decode_attention" if layout != "dense"
            else "decode_attention")
    ops.reset_launch_counts()
    for w in range(8):
        if w == 2:
            prefix = eng.prefill(params, torch.from_numpy(prompts[2]).to(
                cuda))
            ds = eng.insert(prefix, ds, 2)
            tds = twin.insert(prefix, tds, 2)
        ds, res = eng.generate(params, ds)
        tds, tres = twin.generate(params, tds)
        assert torch.equal(res.logits, tres.logits), w
        assert np.array_equal(res.data, tres.data), w
        assert res.data.shape == (3, k + 3)
    for (path, a), (_, b) in zip(state_leaves(ds), state_leaves(tds)):
        if eng._paged and path.startswith("['model']") and path.endswith(
                POOL_LEAVES):
            a, b = a[1:], b[1:]
        assert torch.equal(a, b), path
    g = eng.spec_graph
    assert g.captures == len(eng.spec_keys) >= 1
    assert g.replays == 8 - g.captures
    assert eng.graph.captures == 0
    for key, st in g.stats().items():
        assert st["launches"][read] == _window_reads(cfg, key[0]), key
    if layout == "paged-prefix":
        assert eng.prefix_cache_stats["cow_copies"] > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_replayed_launches_follow_the_window_plans(cuda, layout):
    cfg = dataclasses.replace(PQ.smoke_config(soi="pp"), dtype="bfloat16")
    params = T.cast_params(T.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda), cfg)
    eng = SOIEngine(cfg, device=cuda, speculate=4, **LAYOUTS[layout])
    ds = eng.init_decode_state(params)
    for slot, p in enumerate(_prompts(cfg, 3)):
        ds = eng.insert(eng.prefill(params, torch.from_numpy(p).to(cuda)),
                        ds, slot)
    read = ("paged_decode_attention" if layout != "dense"
            else "decode_attention")
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    torch.cuda.synchronize(cuda)
    ops.reset_launch_counts()
    for _ in range(6):
        ds, _res = eng.generate(params, ds)
    torch.cuda.synchronize(cuda)
    windows = eng.spec_stats["windows"]
    assert ops.launch_counts()[read] == (
        windows * 7 * n_outer + eng.spec_mid_iters * n_mid)
    assert eng.spec_graph.captures == len(eng.spec_keys)
    # the window's restore and masks add no decode read: the draft reads
    # the outer layers K-1 times, the verify every layer it runs
    for (key,), st in eng.spec_graph.stats().items():
        assert st["launches"][read] == _window_reads(cfg, key)
        assert st["launches"].get("copy_pages", 0) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_forced_rejection_on_the_card(cuda, paged, dtype):
    """A wrong guess at depth n in 1..4 through ``verify_commit`` on the
    card: n committed tokens, and the state of n sequential card steps bit
    for bit (pools: outside the null page)."""
    cfg = dataclasses.replace(PQ.smoke_config(soi="pp"), dtype=dtype)
    params = T.cast_params(T.init(cfg, generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda), cfg)
    eng = SOIEngine(cfg, device=cuda, max_concurrent_decodes=3, max_len=32,
                    paged=paged, page_size=4, speculate=4)
    ds = eng.init_decode_state(params)
    for slot, p in enumerate(_prompts(cfg, 6)):
        ds = eng.insert(eng.prefill(params, torch.from_numpy(p[:9 + slot])
                                    .to(cuda)), ds, slot)
    if paged:
        ds = eng._back_spec_window(ds)
        eng._flush_cow(ds)
        eng._refresh_page_maps(ds["model"])
    st0, cur = ds["model"], ds["tokens"].clone()
    ones = torch.ones(3, dtype=torch.bool, device=cuda)
    seq, snaps, st, c = [cur], [], copy.deepcopy(st0), cur
    for _ in range(4):
        lg, st = generate_step(params, cfg, st, c, active=ones)
        c = torch.argmax(lg, -1).to(torch.int32)
        seq.append(c)
        snaps.append(copy.deepcopy(st))
    seq = torch.stack(seq, 1)
    for n in (1, 2, 3, 4):
        inputs = seq[:, :4].clone()
        if n < 4:
            inputs[:, n] = (inputs[:, n] + 1) % cfg.vocab
        sv = copy.deepcopy(st0)
        _, comm, n_acc, nxt, _ = verify_commit(params, cfg, sv, inputs,
                                               active=ones, spec=ones)
        assert n_acc.tolist() == [n] * 3
        assert torch.equal(comm[:, :n], seq[:, 1:1 + n])
        assert torch.equal(nxt, seq[:, n])
        for (path, a), (_, b) in zip(state_leaves(sv),
                                     state_leaves(snaps[n - 1])):
            if paged and path.endswith(POOL_LEAVES):
                a, b = a[1:], b[1:]
            assert torch.equal(a, b), (n, path)


def test_spec_rebound_leaf_raises(cuda):
    cfg = dataclasses.replace(PQ.smoke_config(soi="pp"), dtype="float32")
    params = T.init(cfg, generator=torch.Generator(device=cuda)
                    .manual_seed(4), device=cuda)
    eng = SOIEngine(cfg, device=cuda, max_concurrent_decodes=3, max_len=64,
                    speculate=4)
    ds = eng.init_decode_state(params)
    ds = eng.insert(eng.prefill(params, torch.arange(
        12, dtype=torch.int32, device=cuda)), ds, 0)
    for _ in range(4):
        ds, _res = eng.generate(params, ds)
    assert eng.spec_graph.captures == len(eng.spec_keys)
    key = next(iter(eng.spec_keys))           # captured at its first window
    k = ds["model"]["pre"][0]["k"]
    assert k.nbytes >= 16 * 1024
    ds["model"]["pre"][0]["k"] = k.clone()
    with pytest.raises(DroppedDonationError,
                       match=r"\['pre'\]\[0\]\['k'\]"):
        eng.spec_graph(params, ds, eng._spec_dev, key)
    ds["model"]["pre"][0]["k"] = k
    eng.spec_graph(params, ds, eng._spec_dev, key)
