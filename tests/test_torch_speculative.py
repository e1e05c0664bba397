"""repro_torch's self-speculative decoding against the JAX package on the CPU
(the port of ``tests/test_speculative.py``), float32 smoke configs,
numpy-seeded weights and prompts:

  * greedy tokens of ``SOIEngine(speculate=K)`` equal the port's plain
    engine's for K in {1, 2, 4}, pp and fp, dense rings and paged pools,
    and the JAX speculative engine's for K = 4 (with its
    ``spec_accept_stats`` on the same schedule);
  * a rejection forced at depth n in {1, 2, 3, 4} through
    ``verify_commit`` commits the JAX function's tokens, ``n_acc`` and
    feedback token, its logits within 5e-4, and leaves the decode state
    bit for bit where n sequential port steps leave it (the pools' null
    page aside) — dense and paged; per-slot depths [1, 2, 4] and [4, 1, 3]
    roll back slot by slot;
  * a window with speculation off is one ``generate_step`` bit for bit;
  * a draft burst gives the JAX burst's draft tokens and leaves the decode
    state bit for bit as it was (the null page included: its rows are
    restored too), gathering only the rows it writes;
  * mixed speculative and plain slots, a config without SOI, stride 4,
    deepseek-v2 (MLA absorbed, MoE; dense and paged, 4 slots) and
    recurrentgemma (RG-LRU, window-8 rings that wrap; dense and paged)
    serve the plain engine's tokens;
  * freeing a slot mid-speculation and inserting again gives a fresh
    engine's tokens and leaks no page;
  * the (B, K+3) result layout, the validation errors, and the window
    keys the engine passes — the graphs the card captures — stay within
    the 2^stride - 1 branch patterns of one K.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.deepseek_v2_236b as JDS
import repro.configs.qwen3_1_7b as Q
import repro.configs.recurrentgemma_9b as JRG
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.engine import generate_step as jgenerate_step
from repro.engine.speculative import draft_burst as jdraft_burst
from repro.engine.speculative import verify_commit as jverify_commit
from repro.models import decode as JD
from repro.models import transformer as JT
from repro_torch.configs import deepseek_v2_236b as PDS
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.configs import recurrentgemma_9b as PRG
from repro_torch.convert import from_jax_params
from repro_torch.engine import (SOIEngine, draft_burst, speculative_window,
                                verify_commit)
from repro_torch.engine.contracts import state_leaves
from repro_torch.engine.speculative import draft_rows
from repro_torch.engine.step import generate_step
from repro_torch.models import decode as PD

torch.set_num_threads(1)

ATOL = 5e-4             # the reference engine tests' logit bound
B, K = 3, 4
POOL_LEAVES = ("['k']", "['v']", "['pos']", "['latent']", "['rope']")


def _with_stride(cfg, stride):
    if stride is None:
        return cfg
    return dataclasses.replace(cfg, soi=dataclasses.replace(cfg.soi,
                                                            stride=stride))


def _random_params(cfg, seed=0):
    """Reference-shaped parameter tree drawn by numpy (fan-in scaled
    weights, unit embeddings, nonzero norm scales), so greedy tokens vary."""
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
def _qwen(mode, stride=None):
    jc = _with_stride(dataclasses.replace(Q.smoke_config(soi=mode),
                                          dtype="float32"), stride)
    pc = _with_stride(dataclasses.replace(PQ.smoke_config(soi=mode),
                                          dtype="float32"), stride)
    np_params = _random_params(jc)
    return (jc, pc, jax.tree.map(jnp.asarray, np_params),
            from_jax_params(np_params, pc, device="cpu"))


@functools.lru_cache(maxsize=None)
def _from_init(arch, mode):
    """deepseek-v2 / recurrentgemma smoke weights from the JAX ``init``."""
    jm, pm = {"deepseek-v2": (JDS, PDS), "recurrentgemma": (JRG, PRG)}[arch]
    jc = dataclasses.replace(jm.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(pm.smoke_config(soi=mode), dtype="float32")
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    return pc, from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                               device="cpu")


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _serve(pc, model, prompts, gen, *, paged, speculate=None,
           spec_flags=None, max_len=64, page_size=4, slots=None):
    """Token streams (first token included) of every prompt, and the
    engine and final state."""
    eng = SOIEngine(pc, max_concurrent_decodes=slots or len(prompts),
                    max_len=max_len, device="cpu", paged=paged,
                    page_size=page_size, speculate=speculate)
    ds = eng.init_decode_state(model)
    streams = []
    for i, p in enumerate(prompts):
        prefix = eng.prefill(model, torch.from_numpy(p))
        flag = None if spec_flags is None else spec_flags[i]
        ds = eng.insert(prefix, ds, i, speculate=flag)
        streams.append([int(prefix.first_token[0])])
    while min(len(s) for s in streams) < gen:
        ds, rt = eng.generate(model, ds)
        rt = rt.convert_to_numpy()
        for i in range(len(prompts)):
            sd = rt.get_result_at_slot(i)
            n = 1 if sd.accepted is None else int(sd.accepted[0])
            streams[i].extend(int(x) for x in sd.tokens[:n])
    return [s[:gen] for s in streams], eng, ds


def _states_equal(a, b, *, paged):
    """Every leaf bit for bit; on pools the null page (row 0) aside."""
    la, lb = state_leaves(a), state_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if paged and path.endswith(POOL_LEAVES):
            x, y = x[1:], y[1:]
        assert torch.equal(x, y), path


# -- greedy equivalence ----------------------------------------------------

LAYOUTS = {"dense": False, "paged": True}


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_greedy_tokens_equal_plain_engine(mode, layout, k):
    """Mixed-phase batch (staggered prompts): speculative == plain, token
    for token, for every K, layout and SOI mode."""
    _, pc, _, model = _qwen(mode)
    prompts = _prompts(pc.vocab, [7, 12, 9])
    ref, _, _ = _serve(pc, model, prompts, 18, paged=LAYOUTS[layout])
    got, eng, _ = _serve(pc, model, prompts, 18, paged=LAYOUTS[layout],
                         speculate=k)
    assert got == ref
    assert len({tuple(s) for s in ref}) > 1 or len(set(ref[0])) > 1
    assert eng.spec_stats["windows"] >= 1
    assert {key[0] for key in eng.spec_keys} == {k}


def _jax_serve(jc, jparams, prompts, gen, *, paged, speculate):
    eng = JEngine(jc, max_concurrent_decodes=len(prompts), max_len=64,
                  paged=paged, page_size=4, speculate=speculate)
    ds = eng.init_decode_state(jparams)
    streams = []
    for i, p in enumerate(prompts):
        prefix = eng.prefill(jparams, jnp.asarray(p))
        ds = eng.insert(prefix, ds, i)
        streams.append([int(np.asarray(prefix.first_token)[0])])
    while min(len(s) for s in streams) < gen:
        ds, rt = eng.generate(jparams, ds)
        rt = rt.convert_to_numpy()
        for i in range(len(prompts)):
            sd = rt.get_result_at_slot(i)
            streams[i].extend(int(x) for x in sd.tokens[:int(sd.accepted[0])])
    return [s[:gen] for s in streams], eng.spec_accept_stats()


@functools.lru_cache(maxsize=None)
def _against_jax(layout):
    jc, pc, jparams, model = _qwen("pp")
    prompts = _prompts(pc.vocab, [7, 12, 9])
    ref = _jax_serve(jc, jparams, prompts, 14, paged=LAYOUTS[layout],
                     speculate=K)
    got, eng, _ = _serve(pc, model, prompts, 14, paged=LAYOUTS[layout],
                         speculate=K)
    return ref, (got, eng.spec_accept_stats())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_tokens_equal_jax_speculative_engine(layout):
    (ref, _), (got, _) = _against_jax(layout)
    assert got == ref


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_accept_stats_equal_jax_engine(layout):
    """The same schedule gives the JAX engine's counters: windows, slot
    windows, committed tokens, draft candidates and accepted drafts."""
    (_, ref), (_, got) = _against_jax(layout)
    assert got == ref
    assert got["windows"] > 0 and 0.0 <= got["accept_rate"] <= 1.0


# -- forced rejection: the verify's rollback -------------------------------

@functools.lru_cache(maxsize=None)
def _jax_window(mode):
    """The JAX prefilled state, the true greedy continuation (B, K+1), the
    verify and the draft burst, jitted once a mode."""
    jc, _, jparams, _ = _qwen(mode)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, 8)).astype(
        np.int32)
    lg, st0 = JD.prefill(jparams, jc, jnp.asarray(toks), max_len=64)
    cur = jnp.argmax(lg, -1).astype(jnp.int32)
    ones = jnp.ones((B,), bool)
    jstep = jax.jit(lambda pr, s_, tk: jgenerate_step(pr, jc, s_, tk,
                                                      active=ones))
    seq, st, c = [np.asarray(cur)], st0, cur
    for _ in range(K):
        lgr, st = jstep(jparams, st, c)
        c = jnp.argmax(lgr, -1).astype(jnp.int32)
        seq.append(np.asarray(c))
    verify = jax.jit(lambda pr, s_, inp, spec: jverify_commit(
        pr, jc, s_, inp, active=ones, spec=spec))
    draft = jax.jit(lambda pr, s_, tk: jdraft_burst(pr, jc, s_, tk, k=K,
                                                    active=ones))
    return toks, st0, np.stack(seq, 1), verify, draft


def _port_state(mode, layout, toks):
    """The port's decode state after prefilling ``toks`` (B, 8), and the
    first tokens: dense from ``prefill``; paged through a speculative
    engine whose pages back the K positions of a window."""
    _, pc, _, model = _qwen(mode)
    if layout == "dense":
        lg, st = PD.prefill(model, pc, torch.from_numpy(toks), max_len=64)
        return st, torch.argmax(lg, -1).to(torch.int32)
    eng = SOIEngine(pc, max_concurrent_decodes=B, max_len=64, device="cpu",
                    paged=True, page_size=4, speculate=K)
    ds = eng.init_decode_state(model)
    for i in range(B):
        ds = eng.insert(eng.prefill(model, torch.from_numpy(toks[i])), ds, i)
    ds = eng._back_spec_window(ds)
    eng._flush_cow(ds)
    eng._refresh_page_maps(ds["model"])
    return ds["model"], ds["tokens"].clone()


def _sequential(mode, state, tokens, n):
    """The state after n plain port steps on the given tokens (B, n)."""
    _, pc, _, model = _qwen(mode)
    st = copy.deepcopy(state)
    ones = torch.ones(B, dtype=torch.bool)
    for j in range(n):
        _, st = generate_step(model, pc, st, tokens[:, j], active=ones)
    return st


def _host_pattern(pc, state):
    """The engine's branch pattern for a window where every slot
    speculates: iteration j runs the middle if some slot would reach
    phase 0."""
    t = state["t"].numpy()
    return tuple(bool(np.any((t + j) % pc.soi.stride == 0))
                 for j in range(K))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_rejection_rolls_back_bit_exact(mode, n, layout):
    """A wrong guess at depth n: the JAX verify's tokens, n_acc and
    feedback token, its logits within 5e-4, and the state of n sequential
    port steps bit for bit — rejected iterations leave no trace in any
    cache, clock, conv window or queue."""
    _, pc, jparams, model = _qwen(mode)
    toks, jst0, seq, jverify, _ = _jax_window(mode)
    inputs = seq[:, :K].copy()
    if n < K:
        inputs[:, n] = (inputs[:, n] + 1) % pc.vocab
    _, jcomm, jn, jnxt, jlg = jverify(jparams, jst0, jnp.asarray(inputs),
                                      jnp.ones((B,), bool))
    st0, cur = _port_state(mode, layout, toks)
    assert cur.tolist() == seq[:, 0].tolist()
    ref = _sequential(mode, st0, torch.from_numpy(seq), n)
    st = copy.deepcopy(st0)
    ones = torch.ones(B, dtype=torch.bool)
    _, comm, n_acc, nxt, lg = verify_commit(
        model, pc, st, torch.from_numpy(inputs), active=ones, spec=ones,
        run_mid=_host_pattern(pc, st0))
    assert n_acc.tolist() == np.asarray(jn).tolist() == [n] * B
    assert np.array_equal(comm.numpy(), np.asarray(jcomm))
    assert np.array_equal(comm[:, :n].numpy(), seq[:, 1:1 + n])
    assert nxt.tolist() == np.asarray(jnxt).tolist() == seq[:, n].tolist()
    assert float(np.max(np.abs(lg.numpy() - np.asarray(jlg)))) < ATOL
    _states_equal(st, ref, paged=layout == "paged")


@pytest.mark.parametrize("depths", [[1, 2, 4], [4, 1, 3]])
def test_per_slot_rejection_depths(depths):
    """Slots rejecting at different depths roll back on their own: each
    commits the JAX verify's tokens and feedback token, and its rows of
    every leaf equal those of its own depth's sequential run."""
    _, pc, jparams, model = _qwen("pp")
    toks, jst0, seq, jverify, _ = _jax_window("pp")
    inputs = seq[:, :K].copy()
    for i, d in enumerate(depths):
        if d < K:
            inputs[i, d] = (inputs[i, d] + 1) % pc.vocab
    _, jcomm, jn, jnxt, _ = jverify(jparams, jst0, jnp.asarray(inputs),
                                    jnp.ones((B,), bool))
    st0, _ = _port_state("pp", "dense", toks)
    st = copy.deepcopy(st0)
    ones = torch.ones(B, dtype=torch.bool)
    _, comm, n_acc, nxt, _ = verify_commit(
        model, pc, st, torch.from_numpy(inputs), active=ones, spec=ones)
    assert n_acc.tolist() == np.asarray(jn).tolist() == depths
    assert np.array_equal(comm.numpy(), np.asarray(jcomm))
    assert nxt.tolist() == np.asarray(jnxt).tolist()
    for i, d in enumerate(depths):
        ref = _sequential("pp", st0, torch.from_numpy(seq), d)
        for (path, x), (_, y) in zip(state_leaves(st), state_leaves(ref)):
            assert torch.equal(x[i], y[i]), (i, d, path)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_spec_off_window_equals_one_step(mode, layout):
    """A window whose slots all opted out commits what one plain step
    commits, bit for bit: logits, feedback token and every state leaf."""
    _, pc, _, model = _qwen(mode)
    toks, *_ = _jax_window(mode)
    st0, cur = _port_state(mode, layout, toks)
    ones = torch.ones(B, dtype=torch.bool)
    ref = copy.deepcopy(st0)
    lg_ref, ref = generate_step(model, pc, ref, cur, active=ones)
    st = copy.deepcopy(st0)
    _, _, n_acc, nxt, lg = verify_commit(
        model, pc, st, torch.stack([cur, cur, cur], 1), active=ones,
        spec=torch.zeros(B, dtype=torch.bool))
    assert n_acc.tolist() == [1] * B
    assert torch.equal(lg, lg_ref)
    assert torch.equal(nxt, torch.argmax(lg_ref, -1).to(torch.int32))
    _states_equal(st, ref, paged=layout == "paged")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_draft_burst_matches_jax_and_restores_state(mode, layout):
    """The burst's K-1 draft tokens are the JAX burst's, and the state
    after it is bit for bit the state before (null page included); what
    it gathered is the rows it wrote: 3 positions of every outer ring."""
    _, pc, jparams, model = _qwen(mode)
    toks, jst0, seq, _, jdraft = _jax_window(mode)
    want = np.asarray(jdraft(jparams, jst0, jnp.asarray(seq[:, 0])))
    st, cur = _port_state(mode, layout, toks)
    before = copy.deepcopy(st)
    got = draft_burst(model, pc, st, cur, k=K, active=torch.ones(
        B, dtype=torch.bool))
    assert got.shape == (B, K - 1) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    _states_equal(st, before, paged=False)
    rows = draft_rows(pc, st, K)
    n_outer = len(st["pre"]) + len(st["post"])
    gathered = [v for _, ix, v in rows if ix is not None]
    assert len(gathered) == 3 * n_outer                  # k, v, pos
    assert all(v.shape[:2] == (B, K - 1) for v in gathered)


# -- configurations ---------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_spec_and_plain_slots(layout):
    """Speculative and opted-out requests share one batch; both kinds give
    the plain engine's tokens, and opted-out slots commit one a window."""
    _, pc, _, model = _qwen("pp")
    prompts = _prompts(pc.vocab, [7, 12, 9])
    ref, _, _ = _serve(pc, model, prompts, 16, paged=LAYOUTS[layout])
    got, eng, _ = _serve(pc, model, prompts, 16, paged=LAYOUTS[layout],
                         speculate=K, spec_flags=[True, False, True])
    assert got == ref
    s = eng.spec_accept_stats()
    assert s["draft_candidates"] == 2 * (K - 1) * s["windows"]
    assert s["tokens_per_window"] < K


def test_non_soi_config_speculates():
    """Without SOI the draft step is the verify step: every window commits
    all K."""
    _, pc, _, model = _qwen(None)
    prompts = _prompts(pc.vocab, [7, 9])
    ref, _, _ = _serve(pc, model, prompts, 14, paged=False)
    got, eng, _ = _serve(pc, model, prompts, 14, paged=False, speculate=3)
    assert got == ref
    assert eng.spec_accept_stats()["accept_rate"] == 1.0
    assert eng.spec_keys == {(3, None)}


def test_stride_4():
    _, pc, _, model = _qwen("pp", 4)
    prompts = _prompts(pc.vocab, [8, 11])
    ref, _, _ = _serve(pc, model, prompts, 16, paged=False)
    got, eng, _ = _serve(pc, model, prompts, 16, paged=False, speculate=K)
    assert got == ref
    assert len(eng.spec_keys) <= 2 ** 4 - 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_deepseek_mla_absorbed(layout):
    """MLA (the absorbed decode read) and MoE through speculative windows,
    four slots (one dispatch group a token)."""
    pc, model = _from_init("deepseek-v2", "pp")
    prompts = _prompts(pc.vocab, [7, 10, 9])
    kw = dict(paged=LAYOUTS[layout], page_size=8, max_len=32, slots=4)
    ref, _, _ = _serve(pc, model, prompts, 12, **kw)
    got, _, _ = _serve(pc, model, prompts, 12, speculate=2, **kw)
    assert got == ref


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_recurrentgemma_wrapping_rings(layout):
    """RG-LRU states and window-8 rings that wrap inside the windows (max
    len 32, prompts of 11 and 12): the draft restores the RG-LRU states
    and the wrapped ring rows, the verify masks them."""
    pc, model = _from_init("recurrentgemma", "pp")
    prompts = _prompts(pc.vocab, [11, 12, 9])
    kw = dict(paged=LAYOUTS[layout], page_size=4, max_len=32)
    ref, _, _ = _serve(pc, model, prompts, 16, **kw)
    got, _, _ = _serve(pc, model, prompts, 16, speculate=K, **kw)
    assert got == ref


# -- engine bookkeeping -----------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_free_mid_speculation_then_reinsert(layout):
    """Free a slot between windows and insert a new request: its tokens
    are a fresh engine's, the pools hold what the fresh engine's hold, and
    freeing both slots drains them."""
    _, pc, _, model = _qwen("pp")
    paged = LAYOUTS[layout]
    prompts = _prompts(pc.vocab, [7, 12])
    newp = _prompts(pc.vocab, [9], seed=3)[0]

    def run(eng, ds, streams):
        for _ in range(4):
            ds, rt = eng.generate(model, ds)
            rt = rt.convert_to_numpy()
            for i in range(2):
                sd = rt.get_result_at_slot(i)
                streams[i].extend(
                    int(x) for x in sd.tokens[:int(sd.accepted[0])])
        return ds

    eng = SOIEngine(pc, max_concurrent_decodes=2, max_len=128, device="cpu",
                    paged=paged, page_size=4, speculate=K)
    ds = eng.init_decode_state(model)
    for i, p in enumerate(prompts):
        ds = eng.insert(eng.prefill(model, torch.from_numpy(p)), ds, i)
    for _ in range(3):
        ds, _ = eng.generate(model, ds)
    ds = eng.free_slot(ds, 0)
    assert not eng._spec_pending[0] and not eng._spec_slots[0]
    ds = eng.insert(eng.prefill(model, torch.from_numpy(newp)), ds, 0)
    streams = [[], []]
    ds = run(eng, ds, streams)

    eng2 = SOIEngine(pc, max_concurrent_decodes=2, max_len=128,
                     device="cpu", paged=paged, page_size=4, speculate=K)
    ds2 = eng2.init_decode_state(model)
    ds2 = eng2.insert(eng2.prefill(model, torch.from_numpy(newp)), ds2, 0)
    ref = [[], []]
    ds2 = run(eng2, ds2, ref)
    assert streams[0] == ref[0]
    if paged:
        used = {k: v["used"] for k, v in eng.pool_stats().items()}
        ds = eng.free_slot(ds, 1)
        used2 = {k: v["used"] for k, v in eng.pool_stats().items()}
        assert used2 == {k: v["used"] for k, v in eng2.pool_stats().items()}
        assert all(used[k] > used2[k] for k in used)
        ds = eng.free_slot(ds, 0)
        for pt in (eng._pt_outer, eng._pt_mid):
            assert (pt.map == 0).all() and (pt.refs[1:] == 0).all()


def test_result_tokens_spec_layout():
    """A window's ResultTokens: one (B, K+3) int32 host array [tok_0..
    tok_{K-1}, valid, length, accepted]; a plain step's stays (B, 3)."""
    _, pc, _, model = _qwen("pp")
    eng = SOIEngine(pc, max_concurrent_decodes=2, max_len=64, device="cpu",
                    speculate=3)
    ds = eng.init_decode_state(model)
    prefix = eng.prefill(model, torch.from_numpy(_prompts(pc.vocab, [8])[0]))
    ds = eng.insert(prefix, ds, 0)
    ds, rt = eng.generate(model, ds)
    assert rt.tokens_idx == (0, 3) and rt.accepted_idx == (5, 6)
    rt = rt.convert_to_numpy()
    assert rt.data.shape == (2, 6) and rt.data.dtype == np.int32
    sd0, sd1 = rt.get_result_at_slot(0), rt.get_result_at_slot(1)
    assert sd0.tokens.shape == (3,)
    n = int(sd0.accepted[0])
    assert 1 <= n <= 3 and int(sd0.lengths[0]) == 8 + n
    assert int(sd0.valid[0]) == 1 and int(sd1.valid[0]) == 0
    plain = SOIEngine(pc, max_concurrent_decodes=2, max_len=64, device="cpu")
    pds = plain.insert(prefix, plain.init_decode_state(model), 0)
    _, prt = plain.generate(model, pds)
    prt = prt.convert_to_numpy()
    assert prt.data.shape == (2, 3) and prt.accepted_idx is None
    assert prt.get_result_at_slot(0).accepted is None
    assert int(prt.get_result_at_slot(0).tokens[0]) == int(sd0.tokens[0])


def test_speculate_validation():
    _, pc, _, model = _qwen("pp")
    for bad in (0, -2):
        with pytest.raises(ValueError, match="speculate"):
            SOIEngine(pc, device="cpu", speculate=bad)
    eng = SOIEngine(pc, max_concurrent_decodes=1, max_len=64, device="cpu")
    ds = eng.init_decode_state(model)
    prefix = eng.prefill(model, torch.from_numpy(_prompts(pc.vocab, [8])[0]))
    with pytest.raises(ValueError, match="speculate=K"):
        eng.insert(prefix, ds, 0, speculate=True)
    eng.insert(prefix, ds, 0, speculate=False)      # opting out is fine
    with pytest.raises(ValueError, match="k >= 1"):
        speculative_window(model, pc, ds["model"], ds["tokens"], k=0,
                           active=ds["active"], spec=ds["active"])


def test_window_keys_stay_within_the_branch_patterns(monkeypatch):
    """The card captures one graph a window key: K and the verify's
    branch pattern from the host clocks. Churn (free, a late opted-out
    insert) changes the pattern, never K; a stride-2 config has at most 3
    patterns, and each key passed is the one the host clocks give."""
    _, pc, _, model = _qwen("pp")
    eng = SOIEngine(pc, max_concurrent_decodes=3, max_len=128, device="cpu",
                    paged=True, page_size=4, speculate=K)
    seen = []
    orig = eng.spec_graph

    def spy(params, ds, spec, key):
        want = eng._window_key()
        clocks = eng._clock.copy()
        seen.append(key)
        assert key == want
        occ = eng._occupied
        specs = occ & eng._spec_slots
        for j, mid in enumerate(key[1]):
            live = occ if j == 0 else specs
            assert mid == bool(np.any(((clocks + j) % 2 == 0) & live))
        return orig(params, ds, spec, key)

    spy.reset = orig.reset
    monkeypatch.setattr(eng, "spec_graph", spy)
    ds = eng.init_decode_state(model)
    for i, p in enumerate(_prompts(pc.vocab, [7, 12, 9])):
        ds = eng.insert(eng.prefill(model, torch.from_numpy(p)), ds, i)
    for _ in range(5):
        ds, _ = eng.generate(model, ds)
    ds = eng.free_slot(ds, 1)
    ds = eng.insert(eng.prefill(model, torch.from_numpy(
        _prompts(pc.vocab, [10], seed=2)[0])), ds, 1, speculate=False)
    for _ in range(5):
        ds, _ = eng.generate(model, ds)
    assert eng.spec_keys == set(seen)
    assert 1 <= len(eng.spec_keys) <= 2 ** pc.soi.stride - 1
    assert {k for k, _ in eng.spec_keys} == {K}
    assert eng.spec_mid_iters == sum(sum(p) for _, p in seen)
    eng.init_decode_state(model)
    assert eng.spec_keys == set()
