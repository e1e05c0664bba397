"""repro_torch.engine vs the JAX reference on the CPU.

  * a batch whose slots sit at different SOI phases — one inserted
    mid-decode — decodes to the reference's offline logits (teacher
    forced), and greedily to the same tokens as the reference SOIEngine on
    the same weights, in pp and fp;
  * free_slot scrubs and freezes a slot, and a re-inserted request decodes
    exactly as in a fresh engine;
  * a step in which no active slot is at phase 0 never runs the middle;
  * the serving driver gives the reference driver's tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.qwen3_1_7b as Q
import repro.launch.serve as jserve
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import transformer as JT
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as pserve

torch.set_num_threads(1)

S = 16
LOGIT_ATOL = 5e-4       # the reference engine test's own bound


def _cfgs(mode):
    jc = dataclasses.replace(Q.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(PQ.smoke_config(soi=mode), dtype="float32")
    return jc, pc


def _random_params(cfg, seed=0):
    """Reference-shaped parameter tree, every leaf drawn by numpy (fan-in
    scaled weights, unit embeddings, nonzero norm scales)."""
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
    jc, pc = _cfgs(mode)
    np_params = _random_params(jc)
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = from_jax_params(np_params, pc, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (3, S)).astype(np.int32)
    full = np.asarray(jax.jit(lambda p, t: JT.forward(p, jc, t))(
        jparams, jnp.asarray(tokens)))
    return jc, pc, jparams, model, tokens, full


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_mixed_phase_batch_matches_offline(mode):
    """Requests at offsets 5 and 6 (phases 1 and 0) decode side by side; a
    third arrives after 3 steps (port of the reference engine test)."""
    _, pc, _, model, tokens, full = _setup(mode)
    engine = SOIEngine(pc, max_concurrent_decodes=4, max_len=S, device="cpu")
    ds = engine.init_decode_state(model)
    offsets = [5, 6]
    for slot, off in enumerate(offsets):
        prefix = engine.prefill(model, torch.from_numpy(tokens[slot, :off]))
        err = float(np.max(np.abs(prefix.logits[0].numpy()
                                  - full[slot, off - 1])))
        assert err < LOGIT_ATOL, (mode, slot, err)
        ds = engine.insert(prefix, ds, slot)

    cursor = dict(enumerate(offsets))
    late_off = 8
    for k in range(S - late_off + 3):
        if k == 3:
            prefix = engine.prefill(model, torch.from_numpy(
                tokens[2, :late_off]))
            ds = engine.insert(prefix, ds, 2)
            cursor[2] = late_off
        forced = ds["tokens"].clone()
        for r, c in cursor.items():
            if c < S:
                forced[r] = int(tokens[r, c])
        ds, result = engine.generate(model, dict(ds, tokens=forced))
        for r, c in list(cursor.items()):
            if c < S:
                err = float(np.max(np.abs(result.logits[r].numpy()
                                          - full[r, c])))
                assert err < LOGIT_ATOL, (mode, r, c, err)
                cursor[r] = c + 1
    assert min(cursor.values()) > max(offsets)


def _greedy_run(engine, params, prompts, to_dev, n_steps=10, late_at=3):
    """Insert prompts 0 and 1, run ``late_at`` steps, insert prompt 2, run
    to ``n_steps``; returns the (first token, step tokens) of every slot."""
    ds = engine.init_decode_state(params)
    toks = {}
    for slot in (0, 1):
        prefix = engine.prefill(params, to_dev(prompts[slot]))
        toks[slot] = [int(np.asarray(prefix.first_token)[0])]
        ds = engine.insert(prefix, ds, slot)
    for k in range(n_steps):
        if k == late_at:
            prefix = engine.prefill(params, to_dev(prompts[2]))
            toks[2] = [int(np.asarray(prefix.first_token)[0])]
            ds = engine.insert(prefix, ds, 2)
        ds, res = engine.generate(params, ds)
        data = np.asarray(res.convert_to_numpy().data)
        for slot in toks:
            toks[slot].append(int(data[slot, 0]))
    return toks


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_greedy_tokens_match_reference_engine(mode):
    jc, pc, jparams, model, tokens, _ = _setup(mode)
    prompts = [tokens[0, :5], tokens[1, :6], tokens[2, :4]]
    ref = _greedy_run(JEngine(jc, max_concurrent_decodes=3, max_len=S),
                      jparams, prompts, jnp.asarray)
    got = _greedy_run(SOIEngine(pc, max_concurrent_decodes=3, max_len=S,
                                device="cpu"),
                      model, prompts, torch.from_numpy)
    assert got == ref


def test_free_slot_then_reinsert_matches_fresh_engine():
    """free_slot scrubs the slot's position lanes and freezes its clock;
    free -> N steps -> re-insert decodes exactly like a fresh state."""
    _, pc, _, model, tokens, _ = _setup("pp")
    eng = SOIEngine(pc, max_concurrent_decodes=2, max_len=S, device="cpu")

    def drive(ds, cur, n):
        outs = {}
        for _ in range(n):
            forced = ds["tokens"].clone()
            for r, (row, c) in cur.items():
                forced[r] = int(tokens[row, c])
            ds, res = eng.generate(model, dict(ds, tokens=forced))
            for r, (row, c) in list(cur.items()):
                outs.setdefault(r, []).append(res.logits[r].clone())
                cur[r] = (row, c + 1)
        return ds, outs

    ds = eng.init_decode_state(model)
    ds = eng.insert(eng.prefill(model, torch.from_numpy(tokens[0, :6])),
                    ds, 0)
    ds = eng.insert(eng.prefill(model, torch.from_numpy(tokens[1, :5])),
                    ds, 1)
    cur = {0: (0, 6), 1: (1, 5)}
    ds, _ = drive(ds, cur, 3)
    ds = eng.free_slot(ds, 0)
    t_frozen = int(ds["model"]["t"][0])
    for grp in ("pre", "mid", "post"):
        for c in ds["model"][grp]:
            assert bool((c["pos"][0] == -1).all()), grp
    with pytest.raises(ValueError, match="not occupied"):
        eng.free_slot(ds, 0)
    del cur[0]
    ds, _ = drive(ds, cur, 3)
    assert int(ds["model"]["t"][0]) == t_frozen
    prefix = eng.prefill(model, torch.from_numpy(tokens[2, :7]))
    ds = eng.insert(prefix, ds, 0)
    cur[0] = (2, 7)
    _, outs_a = drive(ds, cur, 5)

    ds2 = eng.init_decode_state(model)
    ds2 = eng.insert(prefix, ds2, 0)
    _, outs_b = drive(ds2, {0: (2, 7)}, 5)
    for a, b in zip(outs_a[0], outs_b[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_off_phase_step_skips_the_middle(mode, monkeypatch):
    """The middle's attention runs only on steps where some active slot is
    at phase 0: an all-off-phase step launches attention in the outer
    layers alone (the host-visible form of SOI's saving)."""
    _, pc, _, model, tokens, _ = _setup(mode)
    calls = []
    orig = kops.decode_attention

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(kops, "decode_attention", counting)
    n_outer = pc.soi.first_layer + pc.n_layers - pc.soi.last_layer
    n_mid = pc.soi.last_layer - pc.soi.first_layer
    eng = SOIEngine(pc, max_concurrent_decodes=2, max_len=S, device="cpu")
    ds = eng.init_decode_state(model)
    for slot, off in ((0, 5), (1, 7)):        # both at phase 1 after prefill
        ds = eng.insert(eng.prefill(model, torch.from_numpy(
            tokens[slot, :off])), ds, slot)
    for step in range(4):
        calls.clear()
        ds, _ = eng.generate(model, ds)
        want = n_outer + (n_mid if step % 2 == 1 else 0)
        assert len(calls) == want, (mode, step, len(calls))
    assert (eng.steps, eng.mid_steps) == (4, 2)


def test_serve_matches_reference_driver(monkeypatch):
    """repro_torch's serving loop on the reference driver's weights and
    prompts returns the reference driver's tokens (float32 smoke config,
    staggered prompts at mixed phases)."""
    argv = ["--smoke", "--soi", "pp", "--batch", "3", "--prompt-len", "12",
            "--gen-len", "6", "--stagger", "1", "--seed", "0"]
    jc, pc = _cfgs("pp")
    orig = Q.smoke_config
    monkeypatch.setattr(Q, "smoke_config", lambda soi=None:
                        dataclasses.replace(orig(soi=soi), dtype="float32"))
    init = jax.jit(JT.init, static_argnums=1)
    monkeypatch.setattr(JT, "init", init)
    ref = jserve.main(argv)

    rng = jax.random.PRNGKey(0)
    np_params = jax.tree.map(np.asarray, split_axes(init(rng, jc))[0])
    prompt = np.asarray(jax.random.randint(jax.random.fold_in(rng, 1),
                                           (3, 12), 0, jc.vocab))
    model = from_jax_params(np_params, pc, device="cpu")
    engine = SOIEngine(pc, max_concurrent_decodes=3, max_len=12 + 6,
                       device="cpu")
    got = pserve.serve(engine, model, torch.from_numpy(np.array(prompt)),
                       [12, 11, 10], 6)
    np.testing.assert_array_equal(got.seqs, np.asarray(ref))


def test_serve_main_runs_on_cpu_when_asked():
    seqs = pserve.main(["--smoke", "--soi", "fp", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "9", "--gen-len",
                        "4"])
    assert seqs.shape == (2, 4)
    assert ((seqs >= 0) & (seqs < PQ.smoke_config().vocab)).all()
    with pytest.raises(NotImplementedError, match="not ported"):
        pserve.main(["--smoke", "--device", "cpu", "--trace-out", "t.json"])
    with pytest.raises(NotImplementedError, match="not ported"):
        SOIEngine(PQ.smoke_config(soi="pp"), device="cpu", telemetry=True)


def test_entry_points_default_to_cuda():
    """Without a card, the engine and the driver refuse to run unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SOIEngine(PQ.smoke_config(soi="pp"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pserve.main(["--smoke", "--batch", "1", "--prompt-len", "4",
                     "--gen-len", "2"])
