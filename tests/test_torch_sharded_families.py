"""RWKV, the encoder-decoder and the prefix-LM through the port's sharded
``launch.steps`` (``make_train_step``, ``make_prefill``,
``make_serve_step`` with rules and a mesh) on gloo ranks, in float32,
against the JAX reference's *unsharded* steps on the same numpy weights.
``sharding.shard_params`` splits RWKV's ``wr``/``wk``/``wv``/``wg``/
``cm_k``/``cm_r`` columns and ``wo``/``cm_v`` rows (its heads and ``S``
over the model axis, the LoRAs and per-channel vectors replicated),
whisper's encoder and decoder heads, cross projections and MLPs, and
paligemma's query heads beside MQA's one replicated KV head. Configs:
rwkv6-1.6b smoke SOI pp, whisper-tiny smoke (its 256-row vocab split) and
the same at a vocab of 257, which no model axis here divides (the
embedding and the tied head then stay whole on every rank, as the
reference's ``spec_for`` replicates them), paligemma-3b smoke (SOI pp in
training; its SOI prefill raises, as the reference's), each behind random
stub frontends:

  * serving — ``make_prefill`` over a 12-token prompt at B 4 (paligemma's
    8 patch embeddings ahead of it, whisper's 16 encoder frames beside
    it), the clocks staggered by 0..3, then two greedy
    ``make_serve_step`` steps, max_len 32, from the JAX ``init`` weights:
    tokens equal the reference's, logits within ``ATOL``; every rank's
    state leaves of ``decode_state_specs``' local shapes and bytes, the
    model axis splitting the rings' rows, RWKV's ``S`` heads and whisper's
    cross K/V frames;
  * training — two steps at B 8 x S 16 (targets masked unevenly across
    the data ranks), held to the jitted JAX unsharded ``make_train_step``
    on the family gain's weights: the metrics to ``TOL`` at the first
    step and 10 x ``TOL`` at the second, params and moments to
    ``BOUNDS`` (``tests/test_torch_train.py``); every rank's parameter and
    moment shard bytes equal ``per_device_bytes`` of the dry run's specs
    under the case's rules;
  * meshes: each family on 1 x 2 and 2 x 2 (data x model); rwkv6 and
    whisper also on 1 x 2 with seq_shard (the first step's ``split_seq``
    and reduce-scatter calls say the carry split), paligemma on 2 x 1
    with fsdp; whisper at vocab 257 on 1 x 2;
  * a one-process 1 x 1 gloo world, bit for bit the plain port steps.

Three spawns (two of 2 ranks and one of 4, at once) run every case
(``_torch_ranks``' ``families`` job), while this process computes the JAX
references.
"""

import dataclasses
import functools
import importlib
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks as R
from repro.distributed.sharding import split_axes
from repro.launch.steps import make_prefill as jmake_prefill
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro_torch.convert import from_jax_params
from repro_torch.distributed.sharding import (ShardingRules, gather_params,
                                              gather_tree, per_device_bytes,
                                              shard_params)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import AbstractMesh, make_mesh
from repro_torch.launch.steps import (local_batch, make_prefill,
                                      make_serve_step, make_train_step)
from repro_torch.optim import adamw_init
from test_torch_train import BOUNDS, STEP_KW, TOL, _by_name, _rel, _share_off
from test_torch_train_families import _random_params as _family_params

torch.set_num_threads(1)

ATOL = 5e-4                  # port vs JAX serving (PERF.md §2)
B, PROMPT, STEPS, MAX_LEN = 4, 12, 2, 32
STAGGER = np.array([0, 1, 2, 3], np.int32)
TB, TS, TRAIN_STEPS = 8, 16, 2
# config: (arch module, SOI mode, vocab or None for the config's)
CONFIGS = {"rwkv6 pp": ("rwkv6_1_6b", "pp", None),
           "whisper": ("whisper_tiny", None, None),
           "whisper v257": ("whisper_tiny", None, 257),
           "paligemma": ("paligemma_3b", None, None),
           "paligemma pp": ("paligemma_3b", "pp", None)}
# mesh: (shape, rules flags)
MESHES = {"1x2": ((1, 2), {}), "2x2": ((2, 2), {}),
          "1x2 seq": ((1, 2), dict(seq_shard=True)),
          "2x1 fsdp": ((2, 1), dict(fsdp=True))}
# the meshes of each spawned world (three at once: two of 2 ranks, one of
# 4), about even in work
SPAWNS = (("1x2",), ("1x2 seq", "2x1 fsdp"), ("2x2",))
SERVE = {f"{c} {m}": (c, m) for c, ms in (
    ("rwkv6 pp", ("1x2", "2x2", "1x2 seq")),
    ("whisper", ("1x2", "2x2", "1x2 seq")),
    ("whisper v257", ("1x2",)),
    ("paligemma", ("1x2", "2x2", "2x1 fsdp"))) for m in ms}
# split_seq calls of a seq_shard train step's forward on 1 x 2: rwkv6
# pp's SOI post carry and its middle's 8 frames, and each of its 4 channel
# mixes handing back the rank's rows; whisper's position table rows
SEQ_SPLITS = {"rwkv6 pp": 6, "whisper": 1}
TRAIN = {f"{c} {m}": (c, m) for c, ms in (
    ("rwkv6 pp", ("1x2", "2x2", "1x2 seq")),
    ("whisper", ("1x2", "2x2", "1x2 seq")),
    ("whisper v257", ("1x2",)),
    ("paligemma pp", ("1x2", "2x2", "2x1 fsdp"))) for m in ms}


@functools.lru_cache(maxsize=None)
def _cfgs(config):
    mod, mode, vocab = CONFIGS[config]
    out = []
    for pkg in ("repro.configs", "repro_torch.configs"):
        cfg = dataclasses.replace(importlib.import_module(
            f"{pkg}.{mod}").smoke_config(soi=mode), dtype="float32")
        out.append(cfg if vocab is None else
                   dataclasses.replace(cfg, vocab=vocab))
    return tuple(out)


def _stubs(cfg, b, rng) -> dict:
    """Random stub frontends: patch embeddings (b, P, d) and encoder
    frames (b, n_frames, d_enc)."""
    out = {}
    if cfg.frontend == "patch_stub":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        out["encoder_frames"] = rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.encoder.d_model)).astype(
                np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _serve_inputs(config):
    """The JAX ``init`` weights of the config (jitted) and a B 4 prompt of
    12 tokens with its stubs."""
    jc, _ = _cfgs(config)
    params = jax.jit(lambda key: split_axes(JT.init(key, jc))[0])(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (B, PROMPT)).astype(np.int32)
    return jax.tree.map(np.asarray, params), tokens, _stubs(jc, B, rng)


@functools.lru_cache(maxsize=None)
def _train_inputs(config):
    """The family gain's weights and a B 8 x S 16 batch of next-token
    targets with its stubs; rows 0, 1 and 4 — data rank 0's on every mesh
    — lose most of their targets, the others none."""
    jc, _ = _cfgs(config)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (TB, TS)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[0, :12] = -1
    targets[1, :10] = -1
    targets[4, :8] = -1
    return _family_params(jc), {"tokens": tokens, "targets": targets,
                                **_stubs(jc, TB, rng)}


def _case(mesh_name, **kw):
    shape, rules = MESHES[mesh_name]
    return dict(mesh=shape, names=("data", "model"), rules=rules, **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every world spawned at once; the JAX references are computed while
    the ranks run."""
    procs = []
    pool = ThreadPoolExecutor(3)       # XLA compiles with the GIL released
    serve_cfgs = {c for c, _ in SERVE.values()}
    for f in [pool.submit(_serve_inputs, c) for c in serve_cfgs]:
        f.result()
    for i, meshes in enumerate(SPAWNS):
        world = math.prod(MESHES[meshes[0]][0])
        tmp = tmp_path_factory.mktemp(f"sharded_families_{i}")
        inp = {"serve": {}, "train": {}}
        for name, (config, mesh) in SERVE.items():
            if mesh in meshes:
                params, tokens, stubs = _serve_inputs(config)
                inp["serve"][name] = _case(
                    mesh, cfg=_cfgs(config)[1], max_len=MAX_LEN,
                    params=params, tokens=tokens, stubs=stubs,
                    stagger=STAGGER, steps=STEPS)
        for name, (config, mesh) in TRAIN.items():
            if mesh in meshes:
                params, batch = _train_inputs(config)
                inp["train"][name] = _case(
                    mesh, cfg=_cfgs(config)[1], params=params, batch=batch,
                    steps=TRAIN_STEPS, bytes=True,
                    step_kw=dict(microbatches=1, **STEP_KW))
        R._save(tmp, "families_in.pkl", inp)
        procs.append((tmp, R.spawn(world, "families", tmp, join=False)))
    try:
        with pool:
            for f in [pool.submit(_train_reference, c) for c in
                      {c for c, _ in TRAIN.values()}] + [
                    pool.submit(_serve_reference, c) for c in serve_cfgs]:
                f.result()
    finally:
        for _, ctx in procs:
            R.wait(ctx)
    out = {}
    for tmp, _ in procs:
        got = R.load(tmp, "families_out.pkl")
        for part in ("serve", "train"):
            out.setdefault(part, {}).update(got[part])
    return out


@functools.lru_cache(maxsize=None)
def _serve_reference(config):
    """The JAX unsharded prefill, the staggered clocks and the greedy
    steps: (logits of every step, tokens fed)."""
    jc, _ = _cfgs(config)
    params, tokens, stubs = _serve_inputs(config)
    jp = jax.tree.map(jnp.asarray, params)
    logits, state = jax.jit(jmake_prefill(jc, max_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(tokens),
             **{k: jnp.asarray(v) for k, v in stubs.items()}})
    state["t"] = state["t"] - jnp.asarray(STAGGER)
    step = jax.jit(jmake_serve_step(jc))
    out, toks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, state = step(jp, state, tok)
        out.append(np.asarray(logits))
    return out, toks


@functools.lru_cache(maxsize=None)
def _train_reference(config):
    """The jitted JAX unsharded step, twice: (metrics of each step,
    params, moments, the sum of the learning rates, the step count)."""
    jc, pc = _cfgs(config)
    params, batch = _train_inputs(config)
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(jmake_train_step(jc, **STEP_KW))
    jopt = jadamw_init(jparams)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics, lr_sum = [], 0.0
    for _ in range(TRAIN_STEPS):
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        metrics.append({k: float(v) for k, v in jm.items()})
        lr_sum += float(jm["lr"])
    return (metrics, _by_name(jparams, pc),
            {t: _by_name(jopt[t], pc) for t in ("mu", "nu")}, lr_sum,
            int(jopt["count"]))


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_serve_matches_the_jax_unsharded_steps(run, name):
    config, mesh = SERVE[name]
    got = run["serve"][name]
    want_logits, want_tokens = _serve_reference(config)
    assert len(got["tokens"]) == len(want_tokens) == STEPS
    for step, (g, w) in enumerate(zip(got["tokens"], want_tokens)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {step}")
    for step, (g, w) in enumerate(zip(got["logits"], want_logits)):
        assert g.shape == w.shape == (B, _cfgs(config)[0].vocab)
        err = float(np.max(np.abs(g - w)))
        assert err < ATOL, (step, err)
    # seq_shard: the prefill's carry splits (every model axis here divides
    # the prompt)
    split = bool(MESHES[mesh][1].get("seq_shard"))
    assert (got["seq_calls"].get("split_seq", 0) > 0) == split, \
        got["seq_calls"]


@pytest.mark.parametrize("name", list(SERVE))
def test_state_shards_have_the_specs_layout(run, name):
    """Every rank's leaves have the specs' local shapes, dtypes and bytes,
    and the model axis splits exactly the rings' rows (k, v, pos),
    RWKV's ``S`` heads and whisper's cross K/V frames — RWKV's
    ``x_prev`` and channel-mix state, the cross read's positions, the
    conv window, the queue and the clocks stay whole."""
    config, mesh = SERVE[name]
    got = run["serve"][name]
    assert len(got["ranks"]) == math.prod(MESHES[mesh][0])
    for r, rank in enumerate(got["ranks"]):
        bad = sorted(k for k, ok in rank["shapes_ok"].items() if not ok)
        assert not bad, (r, bad)
        assert rank["dtypes_ok"], r
        assert rank["bytes"] == rank["per_device_bytes"], r
    want = {k for k in got["state"] if k.rsplit(".", 1)[-1] in
            ("k", "v", "pos", "S")}
    assert set(got["split"]) == want
    kinds = {"rwkv6 pp": ".S", "paligemma": ".k"}
    cross = {k for k in want if k.startswith("cross_kv.")}
    if config.startswith("whisper"):
        assert cross and all(got["state"][k].shape[1] == 16 for k in cross)
    else:
        assert not cross
        assert any(k.endswith(kinds[config]) for k in want)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_matches_the_jax_unsharded_step(run, name):
    config, mesh = TRAIN[name]
    got = run["train"][name]
    want, params, moments, lr_sum, count = _train_reference(config)
    for step, (pm, jm) in enumerate(zip(got["metrics"], want)):
        assert set(pm) == set(jm)
        for k in jm:
            if jm[k] == 0.0:
                assert pm[k] == 0.0, (step, k)
            else:
                assert _rel(pm[k], jm[k]) < (TOL if step == 0
                                             else 10 * TOL), \
                    (step, k, pm[k], jm[k])
    assert got["metrics"][-1]["loss"] < got["metrics"][0]["loss"]
    assert got["count"] == count == TRAIN_STEPS
    trees = {"params": (got["params"], params)}
    trees.update({t: (got[t], moments[t]) for t in ("mu", "nu")})
    for t, (g, w) in trees.items():
        assert set(g) == set(w), t
        bound, share = BOUNDS[False][t]
        assert _share_off(g, w, bound) <= share, t
    g, w = trees["params"]
    for k in w:
        assert float(np.abs(g[k] - w[k]).max()) <= lr_sum, k
    # what split in the first step: with seq_shard the carry
    # (``SEQ_SPLITS``) and the blocks' sums (reduce-scattered); without it
    # only RWKV's channel-mix sums, reduce-scattered onto cm_r's columns,
    # once a layer in the forward and again where the backward recomputes
    # the layer's remat group
    calls = got["seq_calls"]
    rwkv = config.startswith("rwkv")
    pc = _cfgs(config)[1]
    if MESHES[mesh][1].get("seq_shard"):
        assert calls.get("split_seq", 0) == SEQ_SPLITS[config], calls
        assert calls.get("reduce_scatter_dim", 0) > 0, calls
    elif not MESHES[mesh][1].get("fsdp"):
        assert calls == ({"reduce_scatter_dim": pc.n_layers * (
            2 if pc.remat else 1)} if rwkv else {}), calls


@pytest.mark.parametrize("name", list(TRAIN))
def test_param_shards_have_the_dry_runs_bytes(run, name):
    """Every rank's parameter shards and moments (``count`` included)
    take ``per_device_bytes`` of the dry run's specs under the case's
    rules, and every leaf's shard is 1/(its split) of it; heads and
    channels split on a model axis of 2, the leaves' ``"embed"`` on a
    fsdp data axis of 2."""
    config, mesh = TRAIN[name]
    shape, flags = MESHES[mesh]
    rules = ShardingRules(data_axes=("data",), **flags)
    amesh = AbstractMesh(dict(zip(("data", "model"), shape)))
    shapes, specs = S.param_specs(_cfgs(config)[1], rules, amesh)
    want = {"params": per_device_bytes(shapes, specs, amesh),
            "moments": per_device_bytes(S.abstract_opt(shapes),
                                        S.opt_specs(specs), amesh)}
    full = sum(t.numel() * 4 for t in shapes.values())
    ranks = run["train"][name]["bytes"]
    assert len(ranks) == math.prod(shape)
    for r, got in enumerate(ranks):
        assert not got["bad"], (r, got["bad"])
        assert {k: got[k] for k in want} == want, (r, got, want)
        assert got["params"] < full, (r, got["params"], full)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


ONE = ShardingRules(data_axes=("data",))


@pytest.mark.parametrize("config", ["rwkv6 pp", "whisper", "paligemma"])
def test_one_by_one_serve_is_the_plain_steps_bit_for_bit(one_rank, config):
    mesh = one_rank
    _, pc = _cfgs(config)
    params, tokens, stubs = _serve_inputs(config)
    batch = {"tokens": torch.from_numpy(tokens),
             **{k: torch.from_numpy(v) for k, v in stubs.items()}}
    runs = []
    for kw in ({}, dict(rules=ONE, mesh=mesh)):
        model = from_jax_params(params, pc, device="cpu")
        if kw:
            model = shard_params(model, ONE, mesh)
        logits, state = make_prefill(pc, max_len=MAX_LEN, **kw)(model, batch)
        state["t"].sub_(torch.from_numpy(STAGGER))
        step = make_serve_step(pc, **kw)
        out = [logits]
        for _ in range(STEPS):
            logits, state = step(model, state,
                                 out[-1].argmax(-1).to(torch.int32))
            out.append(logits)
        runs.append((out, S.flatten(state)))
    (pl, ps), (sl, ss) = runs
    assert all(torch.equal(a, b) for a, b in zip(pl, sl))
    assert set(ps) == set(ss)
    assert all(torch.equal(ps[k], ss[k]) for k in ps)


@pytest.mark.parametrize("config", ["rwkv6 pp", "whisper", "paligemma pp"])
def test_one_by_one_train_is_the_plain_step_bit_for_bit(one_rank, config):
    mesh = one_rank
    _, pc = _cfgs(config)
    params, np_batch = _train_inputs(config)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    plain = from_jax_params(params, pc, device="cpu")
    popt = adamw_init(dict(plain.named_parameters()))
    pstep = make_train_step(pc, **STEP_KW)
    sharded = shard_params(from_jax_params(params, pc, device="cpu"), ONE,
                           mesh)
    sopt = adamw_init(dict(sharded.named_parameters()))
    sstep = make_train_step(pc, ONE, mesh, **STEP_KW)
    for _ in range(TRAIN_STEPS):
        _, _, pm = pstep(plain, popt, batch)
        _, _, sm = sstep(sharded, sopt, local_batch(batch, mesh))
        assert set(pm) == set(sm)
        for k in pm:
            assert torch.equal(pm[k], sm[k]), k
    want = dict(plain.named_parameters())
    for k, v in gather_params(sharded).items():
        assert torch.equal(v, want[k].detach()), k
    for t in ("mu", "nu"):
        for k, v in gather_tree(sopt[t]).items():
            assert torch.equal(v, popt[t][k]), (t, k)


def test_whisper_tiny_runs_its_vocab_whole():
    """whisper-tiny at its published width on a model axis of 2: its
    51865-row vocab does not split, and the layout check of all three
    steps passes it (the embedding and the tied head whole on every rank,
    ``spec_for`` replicating them); on 4 ranks its 6 heads do not split
    and the steps refuse, naming ROADMAP.md Queue 1 item 8."""
    from repro_torch.configs import whisper_tiny
    from repro_torch.launch import steps as PS
    cfg = whisper_tiny.config()
    notes = []
    _, specs = S.param_specs(cfg, ONE, AbstractMesh({"data": 1, "model": 2}),
                             notes)
    assert specs["embed"] == (None, None)
    assert "axis 'vocab' dim 51865 % mesh 2 != 0 -> replicated" in notes
    for step in ("train", "serve"):
        PS._check_layout(cfg, ONE, 2, step)
        with pytest.raises(NotImplementedError,
                           match="'heads' dim 6 % mesh 4.*Queue 1 item 8"):
            PS._check_layout(cfg, ONE, 4, step)
