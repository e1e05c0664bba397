"""fsdp and sequence parallelism through the port's sharded
``launch.steps`` (``make_train_step``, ``make_prefill``,
``make_serve_step`` with ``ShardingRules(fsdp=..., seq_shard=...)``) on
gloo ranks, in float32, against the JAX reference's *unsharded* steps on
the same numpy weights. fsdp splits every leaf's ``"embed"`` dimension
over the data axes (its master, gradient and moments 1/D a rank) and
gathers the whole leaf for the forward; seq_shard splits the carry
between blocks on its sequence over the model axis (Megatron sequence
parallelism). Configs: nemotron-4-15b smoke (GQA, LayerNorm, squared
ReLU), qwen3 smoke SOI pp, deepseek-v2 smoke SOI pp (MLA + MoE) and
recurrentgemma-9b smoke (RG-LRU + MQA), each on four meshes:

  * 2 x 1 (data x model), fsdp;
  * 1 x 2, seq_shard;
  * 2 x 2, fsdp and seq_shard;
  * 2 x 2 x 1 (pod x data x model), fsdp over both data axes (and
    seq_shard over the one model rank);

  * training — two steps at B 8 (targets masked unevenly across the data
    ranks; nemotron and deepseek-v2 in one microbatch, qwen3 and
    recurrentgemma in two), held to the jitted JAX unsharded
    ``make_train_step`` on the family gain's weights: the
    metrics to ``TOL`` at the first step and 10 x ``TOL`` at the second,
    params and moments to ``BOUNDS`` (``tests/test_torch_train.py``). qwen3
    pp trains at S 18, whose SOI middle of 9 frames the model axis does
    not divide (the middle runs whole, the outer layers split), deepseek-v2
    pp at S 16 (its middle of 8 splits too), and nemotron also at S 15 on
    1 x 2, which the model axis does not divide at all (no split, no
    refusal); the first step's ``split_seq`` and reduce-scatter calls say
    which ran; qwen3 pp on 2 x 1 also with remat off, and on both the
    first step's all-gathers counted: a block's leaves are gathered in
    its layer group, twice a step with remat (the backward's recompute
    gathers them again), once without;
  * every rank's parameter and moment shard bytes equal
    ``per_device_bytes`` of the dry run's specs under its ``KNOBS`` rules
    (fsdp and seq_shard for nemotron, deepseek-v2 and recurrentgemma), and
    every leaf's shard is 1/(its split) of the leaf;
  * serving — ``make_prefill`` over a 12-token prompt at B 4 (the
    clocks staggered to 12, 11, 10 and 9), then two greedy
    ``make_serve_step`` steps, max_len 32, from the JAX ``init`` weights:
    tokens equal the reference's, logits within ``ATOL``, the state's
    bytes a rank ``decode_state_specs``';
  * a one-process 1 x 1 gloo world with fsdp and seq_shard, bit for bit
    the plain port steps.

Two spawns (2 and 4 ranks, at once) run every case (``_torch_ranks``'
``fsdp_sp`` job), while this process computes the JAX references.
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
from repro_torch.launch.dryrun import KNOBS
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
TB, TRAIN_STEPS = 8, 2
# config: (arch module, SOI mode, dry-run arch, train S, microbatches)
CONFIGS = {"nemotron": ("nemotron_4_15b", None, "nemotron-4-15b", 16, 1),
           "qwen3 pp": ("qwen3_1_7b", "pp", "qwen3-1.7b", 18, 2),
           "ds pp": ("deepseek_v2_236b", "pp", "deepseek-v2-236b", 16, 1),
           "rg": ("recurrentgemma_9b", None, "recurrentgemma-9b", 16, 2)}
# mesh: (shape, axis names, rules flags)
MESHES = {"2x1 fsdp": ((2, 1), ("data", "model"), dict(fsdp=True)),
          "1x2 seq": ((1, 2), ("data", "model"), dict(seq_shard=True)),
          "2x2 fsdp seq": ((2, 2), ("data", "model"),
                           dict(fsdp=True, seq_shard=True)),
          "2x2x1 pod fsdp": ((2, 2, 1), ("pod", "data", "model"),
                             dict(fsdp=True, seq_shard=True))}
SERVE = {f"{c} {m}": (c, m) for c in CONFIGS for m in MESHES}
# (config, mesh, microbatches, S)
TRAIN = {f"{c} {m}": (c, m, CONFIGS[c][4], CONFIGS[c][3])
         for c in CONFIGS for m in MESHES}
TRAIN["nemotron 1x2 seq S 15"] = ("nemotron", "1x2 seq", 1, 15)
# fsdp's gathers counted a step, remat on (the smoke config's default) and
# off: each block's leaves are gathered inside its layer group
TRAIN["qwen3 pp 2x1 fsdp no remat"] = ("qwen3 pp", "2x1 fsdp", 2, 18)
NO_REMAT = {"qwen3 pp 2x1 fsdp no remat"}
GATHERS = ["qwen3 pp 2x1 fsdp", "qwen3 pp 2x1 fsdp no remat"]


@functools.lru_cache(maxsize=None)
def _cfgs(config):
    mod, mode = CONFIGS[config][:2]
    return tuple(dataclasses.replace(
        importlib.import_module(f"{pkg}.{mod}").smoke_config(soi=mode),
        dtype="float32") for pkg in ("repro.configs", "repro_torch.configs"))


@functools.lru_cache(maxsize=None)
def _serve_inputs(config):
    """The JAX ``init`` weights of the config (jitted: the eager init
    dispatches op by op) and a B 4 prompt of 12 tokens."""
    jc, _ = _cfgs(config)
    params = jax.jit(lambda key: split_axes(JT.init(key, jc))[0])(
        jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (B, PROMPT)).astype(np.int32)
    return jax.tree.map(np.asarray, params), tokens


@functools.lru_cache(maxsize=None)
def _train_inputs(config, seq):
    """The family gain's weights and a B 8 x ``seq`` batch of next-token
    targets; rows 0, 1 and 4 — data rank 0's on every mesh and
    microbatching — lose most of their targets, the others none."""
    jc, _ = _cfgs(config)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (TB, seq)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[0, :seq * 3 // 4] = -1
    targets[1, :seq * 5 // 8] = -1
    targets[4, :seq // 2] = -1
    return _family_params(jc), {"tokens": tokens, "targets": targets}


def _case(mesh_name, **kw):
    shape, names, rules = MESHES[mesh_name]
    return dict(mesh=shape, names=names, rules=rules, **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds spawned at once; the JAX references are computed while
    the ranks run."""
    procs = []
    pool = ThreadPoolExecutor(3)       # XLA compiles with the GIL released
    for f in [pool.submit(_serve_inputs, c) for c in CONFIGS]:
        f.result()
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sharded_fsdp_sp_{world}")
        inp = {"serve": {}, "train": {}}
        for name, (config, mesh) in SERVE.items():
            if math.prod(MESHES[mesh][0]) == world:
                params, tokens = _serve_inputs(config)
                inp["serve"][name] = _case(
                    mesh, cfg=_cfgs(config)[1], max_len=MAX_LEN,
                    params=params, tokens=tokens, stagger=STAGGER,
                    steps=STEPS)
        for name, (config, mesh, micro, seq) in TRAIN.items():
            if math.prod(MESHES[mesh][0]) == world:
                params, batch = _train_inputs(config, seq)
                inp["train"][name] = _case(
                    mesh, cfg=dataclasses.replace(
                        _cfgs(config)[1], remat=name not in NO_REMAT),
                    params=params, batch=batch, steps=TRAIN_STEPS,
                    bytes=True, gathers=name in GATHERS,
                    step_kw=dict(microbatches=micro, **STEP_KW))
        R._save(tmp, "fsdp_sp_in.pkl", inp)
        procs.append((tmp, R.spawn(world, "fsdp_sp", tmp, join=False)))
    try:
        with pool:
            train = {(c, mb, seq) for c, _, mb, seq in TRAIN.values()}
            for f in [pool.submit(_train_reference, *k) for k in train] + [
                    pool.submit(_serve_reference, c) for c in CONFIGS]:
                f.result()
    finally:
        for _, ctx in procs:
            R.wait(ctx)
    out = {}
    for tmp, _ in procs:
        got = R.load(tmp, "fsdp_sp_out.pkl")
        for part in ("serve", "train"):
            out.setdefault(part, {}).update(got[part])
    return out


@functools.lru_cache(maxsize=None)
def _serve_reference(config):
    """The JAX unsharded prefill, the staggered clocks and the greedy
    steps: (logits of every step, tokens fed)."""
    jc, _ = _cfgs(config)
    params, tokens = _serve_inputs(config)
    jp = jax.tree.map(jnp.asarray, params)
    logits, state = jax.jit(jmake_prefill(jc, max_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(tokens)})
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
def _train_reference(config, micro, seq):
    """The jitted JAX unsharded step, twice: (metrics of each step,
    params, moments, the sum of the learning rates, the step count)."""
    jc, pc = _cfgs(config)
    params, batch = _train_inputs(config, seq)
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(jmake_train_step(jc, microbatches=micro, **STEP_KW))
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
        assert g.shape == w.shape == (B, w.shape[1])
        err = float(np.max(np.abs(g - w)))
        assert err < ATOL, (step, err)
    # the prefill ran sequence-parallel with seq_shard (every model axis
    # here divides the prompt: the blocks' sums reduce-scatter)
    split = bool(MESHES[mesh][2].get("seq_shard"))
    assert (got["seq_calls"].get("reduce_scatter_dim", 0) > 0) == split, \
        got["seq_calls"]
    for r, rank in enumerate(got["ranks"]):
        assert rank["bytes"] == rank["per_device_bytes"], r


def _splits(config, seq, m) -> int:
    """``split_seq`` calls of one microbatch's forward on a model axis of
    ``m``: the SOI post layers' carry, and the middle's where ``m``
    divides its frames; none without SOI (the vocab-split embedding
    reduce-scatters) or where ``m`` does not divide ``seq``."""
    soi = _cfgs(config)[1].soi
    if soi is None or seq % m:
        return 0
    return 1 + (math.ceil(seq / soi.stride) % m == 0)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_matches_the_jax_unsharded_step(run, name):
    config, mesh, micro, seq = TRAIN[name]
    got = run["train"][name]
    want, params, moments, lr_sum, count = _train_reference(config, micro,
                                                            seq)
    moe = config.startswith("ds")
    for step, (pm, jm) in enumerate(zip(got["metrics"], want)):
        assert set(pm) == set(jm)
        for k in jm:
            assert _rel(pm[k], jm[k]) < (TOL if step == 0 else 10 * TOL), \
                (step, k, pm[k], jm[k])
        # the global aux at one microbatch of a MoE stack; else 0
        assert (pm["aux"] > 0) == (moe and micro == 1), (step, pm["aux"])
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
    # what split: the carry where seq_shard and the model axis divides S
    shape, _, rules = MESHES[mesh]
    m = shape[-1]
    calls = got["seq_calls"]
    if rules.get("seq_shard") and m > 1:
        assert calls.get("split_seq", 0) == \
            micro * _splits(config, seq, m), calls
        assert (calls.get("reduce_scatter_dim", 0) > 0) == (seq % m == 0), \
            calls
    if not rules.get("fsdp") and seq % m:
        assert not calls, calls


@pytest.mark.parametrize("name", GATHERS)
def test_fsdp_gathers_each_block_leaf_inside_its_group(run, name):
    """The first step's all-gathers on the 2 x 1 fsdp mesh (its only
    all-gathers are fsdp's): each data-split leaf outside the blocks once
    a microbatch; each block's inside its layer group, so twice with remat
    (the forward, and the backward's recompute of the group) and once
    without. Its results are held to the reference by
    ``test_sharded_train_matches_the_jax_unsharded_step``."""
    config, mesh, micro, _ = TRAIN[name]
    shape, names, rules = MESHES[mesh]
    _, specs = S.param_specs(_cfgs(config)[1], ShardingRules(
        data_axes=names[:-1], **rules), AbstractMesh(dict(zip(names, shape))))
    split = [k for k, spec in specs.items()
             if any("data" in ((a,) if isinstance(a, str) else a or ())
                    for a in spec)]
    blocks = [k for k in split if k.startswith("blocks.")]
    assert blocks and len(blocks) < len(split)
    times = 1 if name in NO_REMAT else 2
    want = micro * (len(split) - len(blocks) + times * len(blocks))
    assert run["train"][name]["seq_calls"]["all_gather_dim"] == want


@pytest.mark.parametrize("name", [n for n in TRAIN if not n.startswith(
    "qwen3") and "S 15" not in n])
def test_param_shards_have_the_dry_runs_bytes(run, name):
    """Every rank's parameter shards and moments (``count`` included) take
    ``per_device_bytes`` of the dry run's specs under the arch's
    ``KNOBS`` rules (fsdp and seq_shard), and every leaf's shard is
    1/(its split) of it: on a fsdp mesh each data-split master and moment
    is 1/D a rank."""
    config, mesh = TRAIN[name][:2]
    shape, names, _ = MESHES[mesh]
    knobs = KNOBS[CONFIGS[config][2]]
    assert knobs["fsdp"] and knobs["seq_shard"]
    rules = ShardingRules(data_axes=names[:-1], fsdp=knobs["fsdp"],
                          seq_shard=knobs["seq_shard"])
    amesh = AbstractMesh(dict(zip(names, shape)))
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
        if math.prod(shape[:-1]) > 1:           # fsdp splits the leaves
            assert got["params"] < full, (r, got["params"], full)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


ONE = ShardingRules(data_axes=("data",), fsdp=True, seq_shard=True)


@pytest.mark.parametrize("config", ["qwen3 pp", "rg"])
def test_one_by_one_serve_is_the_plain_steps_bit_for_bit(one_rank, config):
    mesh = one_rank
    _, pc = _cfgs(config)
    params, tokens = _serve_inputs(config)
    batch = {"tokens": torch.from_numpy(tokens)}
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


@pytest.mark.parametrize("config,micro", [("ds pp", 1), ("nemotron", 2)])
def test_one_by_one_train_is_the_plain_step_bit_for_bit(one_rank, config,
                                                         micro):
    mesh = one_rank
    _, pc = _cfgs(config)
    params, np_batch = _train_inputs(config, CONFIGS[config][3])
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    plain = from_jax_params(params, pc, device="cpu")
    popt = adamw_init(dict(plain.named_parameters()))
    pstep = make_train_step(pc, microbatches=micro, **STEP_KW)
    sharded = shard_params(from_jax_params(params, pc, device="cpu"), ONE,
                           mesh)
    sopt = adamw_init(dict(sharded.named_parameters()))
    sstep = make_train_step(pc, ONE, mesh, microbatches=micro, **STEP_KW)
    for _ in range(TRAIN_STEPS):
        _, _, pm = pstep(plain, popt, batch)
        _, _, sm = sstep(sharded, sopt, local_batch(batch, mesh, micro))
        assert set(pm) == set(sm)
        for k in pm:
            assert torch.equal(pm[k], sm[k]), k
    want = dict(plain.named_parameters())
    for k, v in gather_params(sharded).items():
        assert torch.equal(v, want[k].detach()), k
    for t in ("mu", "nu"):
        for k, v in gather_tree(sopt[t]).items():
            assert torch.equal(v, popt[t][k]), (t, k)
