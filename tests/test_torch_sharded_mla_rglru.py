"""The MLA and RG-LRU stacks, and KV heads the model axis does not split,
through the port's sharded ``launch.steps`` (``make_prefill``,
``make_serve_step``, ``make_train_step`` with rules and a mesh) on gloo
ranks, in float32, against the JAX reference's *unsharded* steps on the
same numpy weights. ``sharding.shard_params`` splits MLA's ``wuq``,
``wuk``, ``wuv`` and ``wo`` on heads (the lora-wide down-projections and
their norms replicated), every RG-LRU weight on ``ff`` or ``heads``, and
leaves MQA's one KV head (and qwen3's 2 on 4 ranks) replicated beside the
split query heads:

  * serving — deepseek-v2 smoke SOI pp (MLA, a dense first layer, MoE with
    a shared expert) and recurrentgemma-9b smoke (RG-LRU, window-8 MQA
    rings that wrap) plain and pp, on 1 x 2, 2 x 2 and 1 x 4 (data x
    model) meshes, and qwen3 smoke's 2 KV heads on 1 x 4: a 12-token
    prompt at B 4, the clocks staggered to 12, 11, 10 and 9, then 8
    greedy steps, max_len 32, from the JAX ``init`` weights; greedy tokens
    equal the reference's, logits within ``ATOL`` at every step, every
    rank's state leaves of ``decode_state_specs``' local shapes and bytes
    (MLA's latent, rope and pos rows split, RG-LRU's ``h`` and ``conv`` on
    ``ff``, every KV head's ring rows split);
  * training — deepseek-v2 smoke pp on 2 x 2 and 1 x 4, recurrentgemma
    smoke on 2 x 2 at microbatches 1 and 2 and on 1 x 4, and qwen3 smoke's
    2 KV heads on 1 x 4, at B 8 x S 32 with targets masked unevenly across
    the data ranks: three steps held to the jitted JAX unsharded
    ``make_train_step`` — metrics to ``TOL`` at the first step and 10 x
    ``TOL`` after, params and moments to ``BOUNDS`` (as
    ``tests/test_torch_sharded_moe.py``). recurrentgemma trains without
    SOI: at this batch its pp config's unsharded port step is already
    past ``BOUNDS`` from the reference (AdamW turns the two frameworks'
    float32 rounding of the GeGLU ``down`` gradients into whole updates),
    so it could not hold the sharded step;
  * every rank's parameter-shard bytes equal ``per_device_bytes`` of the
    specs on each mesh;
  * the refusal that stays (``NotImplementedError`` naming ROADMAP.md
    Queue 1 item 8): 3 KV heads beside 6 query heads on 1 x 2 (2 ranks
    neither divide 3 heads nor are divided by them; RWKV, the
    encoder-decoder and the prefix-LM run since
    ``tests/test_torch_sharded_families.py``);
  * a one-process 1 x 1 gloo world, bit for bit the plain port steps, and
    ``shard_params`` frees the full tensors of the leaves it splits.

Two spawns (2 and 4 ranks, at once) run every case (``_torch_ranks``'
``mla_rglru`` job), while this process computes the JAX references.
"""

import dataclasses
import functools
import gc
import importlib
import math
import weakref
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
from repro_torch import configs as pconfigs
from repro_torch.convert import from_jax_params
from repro_torch.distributed.sharding import (ShardingRules, gather_params,
                                              gather_tree, shard_params)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (local_batch, make_prefill,
                                      make_serve_step, make_train_step)
from repro_torch.optim import adamw_init
from test_torch_train import BOUNDS, STEP_KW, TOL, _by_name, _rel, _share_off
from test_torch_train_families import _random_params as _family_params

torch.set_num_threads(1)

ATOL = 5e-4                  # port vs JAX serving (PERF.md §2)
B, PROMPT, STEPS, MAX_LEN = 4, 12, 8, 32
STAGGER = np.array([0, 1, 2, 3], np.int32)
TB, TS, TRAIN_STEPS = 8, 32, 3
ARCHS = {"ds": "deepseek_v2_236b", "rg": "recurrentgemma_9b",
         "qwen3": "qwen3_1_7b"}
# config: (arch, SOI mode)
CONFIGS = {"ds pp": ("ds", "pp"), "rg": ("rg", None), "rg pp": ("rg", "pp"),
           "qwen3": ("qwen3", None)}
SERVE = {f"{c} {m[0]}x{m[1]}": (c, m) for c in ("ds pp", "rg", "rg pp")
         for m in ((1, 2), (2, 2), (1, 4))}
SERVE["qwen3 1x4"] = ("qwen3", (1, 4))              # 2 KV heads, 4 ranks
TRAIN = {f"{c} {m[0]}x{m[1]} micro {mb}": (c, m, mb)
         for c, m, mb in (("ds pp", (2, 2), 1), ("ds pp", (1, 4), 1),
                          ("rg", (2, 2), 1), ("rg", (2, 2), 2),
                          ("rg", (1, 4), 1), ("qwen3", (1, 4), 1))}
BYTES = {f"{c} {m[0]}x{m[1]}": (c, m) for c in ("ds pp", "rg")
         for m in ((1, 2), (2, 2), (1, 4))}
REFUSED = {"kv 6/3": "kv_heads"}


@functools.lru_cache(maxsize=None)
def _cfgs(config):
    arch, mode = CONFIGS[config]
    return tuple(dataclasses.replace(
        importlib.import_module(f"{pkg}.{ARCHS[arch]}").smoke_config(
            soi=mode), dtype="float32")
        for pkg in ("repro.configs", "repro_torch.configs"))


def _refuse_cfgs():
    """The config the steps still refuse on 1 x 2: qwen3 smoke at 6 query
    / 3 KV heads."""
    cfgs = {}
    q = pconfigs.get_smoke("qwen3-1.7b")
    cfgs["kv 6/3"] = dataclasses.replace(q, segments=tuple(
        dataclasses.replace(seg, blocks=tuple(
            dataclasses.replace(b, attn=dataclasses.replace(
                b.attn, n_heads=6, n_kv=3)) for b in seg.blocks))
        for seg in q.segments))
    return cfgs


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """The JAX ``init`` weights of the arch's SOI pp smoke config, jitted
    (the eager init dispatches op by op: ~20 s for deepseek-v2)."""
    jc = dataclasses.replace(importlib.import_module(
        f"repro.configs.{ARCHS[arch]}").smoke_config(soi="pp"),
        dtype="float32")
    params = jax.jit(lambda key: split_axes(JT.init(key, jc))[0])(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _serve_inputs(config):
    """The JAX ``init`` weights (``_jax_init``; a config without SOI
    leaves its leaves out) and a B 4 prompt of 12 tokens."""
    arch, mode = CONFIGS[config]
    params = dict(_jax_init(arch))
    if mode is None:
        del params["soi"]
    tokens = np.random.default_rng(1).integers(
        0, _cfgs(config)[0].vocab, (B, PROMPT)).astype(np.int32)
    return params, tokens


@functools.lru_cache(maxsize=None)
def _train_inputs(config):
    """The family gain's weights and a B 8 x S 32 batch of next-token
    targets; rows 0, 1 and 4 — data rank 0's on every mesh and
    microbatching — lose most of their targets, the others none."""
    jc, _ = _cfgs(config)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (TB, TS)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[0, :24] = -1
    targets[1, :20] = -1
    targets[4, :18] = -1
    return _family_params(jc), {"tokens": tokens, "targets": targets}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds spawned at once; the JAX references are computed while
    the ranks run."""
    procs = []
    pool = ThreadPoolExecutor(3)       # XLA compiles with the GIL released
    for f in [pool.submit(_jax_init, a) for a in ARCHS]:
        f.result()
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sharded_mla_rglru_{world}")
        inp = {"serve": {}, "train": {}, "bytes": {}}
        for name, (config, mesh) in SERVE.items():
            if math.prod(mesh) == world:
                params, tokens = _serve_inputs(config)
                inp["serve"][name] = dict(
                    cfg=_cfgs(config)[1], mesh=mesh, max_len=MAX_LEN,
                    params=params, tokens=tokens, stagger=STAGGER,
                    steps=STEPS)
        for name, (config, mesh, micro) in TRAIN.items():
            if math.prod(mesh) == world:
                params, batch = _train_inputs(config)
                inp["train"][name] = dict(
                    cfg=_cfgs(config)[1], mesh=mesh, params=params,
                    batch=batch, steps=TRAIN_STEPS,
                    step_kw=dict(microbatches=micro, **STEP_KW))
        for name, (config, mesh) in BYTES.items():
            if math.prod(mesh) == world:
                inp["bytes"][name] = (_cfgs(config)[1], mesh)
        if world == 2:
            inp["refuse"] = _refuse_cfgs()
        R._save(tmp, "mla_rglru_in.pkl", inp)
        procs.append((tmp, R.spawn(world, "mla_rglru", tmp, join=False)))
    try:
        with pool:
            # each once (lru_cache does not hold a second caller back)
            train = dict.fromkeys((c, mb) for c, _, mb in TRAIN.values())
            for f in [pool.submit(_train_reference, *k) for k in train] + [
                    pool.submit(_serve_reference, c) for c in CONFIGS]:
                f.result()
    finally:
        for _, ctx in procs:
            R.wait(ctx)
    out = {}
    for tmp, _ in procs:
        got = R.load(tmp, "mla_rglru_out.pkl")
        for part in ("serve", "train", "bytes"):
            out.setdefault(part, {}).update(got[part])
        if "refused" in got:
            out["refused"] = got["refused"]
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
def _train_reference(config, micro):
    """The jitted JAX unsharded step, three times: (metrics of each step,
    params, moments, the sum of the learning rates, the step count)."""
    jc, pc = _cfgs(config)
    params, batch = _train_inputs(config)
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
    config, _ = SERVE[name]
    got = run["serve"][name]
    want_logits, want_tokens = _serve_reference(config)
    assert len(got["tokens"]) == len(want_tokens) == STEPS
    for step, (g, w) in enumerate(zip(got["tokens"], want_tokens)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {step}")
    for step, (g, w) in enumerate(zip(got["logits"], want_logits)):
        assert g.shape == w.shape == (B, w.shape[1])
        err = float(np.max(np.abs(g - w)))
        assert err < ATOL, (step, err)


@pytest.mark.parametrize("name", list(SERVE))
def test_state_shards_have_the_specs_layout(run, name):
    """Every rank's leaves have the specs' local shapes and bytes, and the
    model axis splits exactly the ring rows (k, v, pos; MLA's latent,
    rope, pos) and the RG-LRU's h and conv (on ``ff``)."""
    _, mesh = SERVE[name]
    got = run["serve"][name]
    assert len(got["ranks"]) == math.prod(mesh)
    for r, rank in enumerate(got["ranks"]):
        bad = sorted(k for k, ok in rank["shapes_ok"].items() if not ok)
        assert not bad, (r, bad)
        assert rank["dtypes_ok"], r
        assert rank["bytes"] == rank["per_device_bytes"], r
    want = {k for k in got["state"] if k.rsplit(".", 1)[-1] in
            ("k", "v", "latent", "rope", "pos", "h", "conv")}
    assert set(got["split"]) == want
    assert any(k.endswith((".latent", ".h", ".k")) for k in want)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_matches_the_jax_unsharded_step(run, name):
    config, _, micro = TRAIN[name]
    got = run["train"][name]
    want, params, moments, lr_sum, count = _train_reference(config, micro)
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


@pytest.mark.parametrize("name", list(BYTES))
def test_param_shards_have_the_dry_runs_bytes(run, name):
    ranks = run["bytes"][name]
    config, mesh = BYTES[name]
    assert len(ranks) == math.prod(mesh)
    full = sum(t.numel() * 4 for t in
               S.abstract_params(_cfgs(config)[1])[0].values())
    for r, (got, want) in enumerate(ranks):
        assert got == want, (r, got, want)
    if mesh[1] > 1:                     # heads and channels split
        assert ranks[0][0] < full


@pytest.mark.parametrize("arch", list(REFUSED))
def test_the_refusals_that_stay(run, arch):
    what = REFUSED[arch]
    for step in ("train", "prefill", "serve"):
        msg = run["refused"][(arch, step)]
        assert msg is not None and "ROADMAP.md" in msg, (arch, step)
        assert "Queue 1 item 8" in msg, (arch, step)
        assert f"'{what}' dim 3 % mesh 2" in msg, msg


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("config", ["ds pp", "rg pp"])
def test_one_by_one_serve_is_the_plain_steps_bit_for_bit(one_rank, config):
    mesh = one_rank
    _, pc = _cfgs(config)
    params, tokens = _serve_inputs(config)
    batch = {"tokens": torch.from_numpy(tokens)}
    rules = ShardingRules(data_axes=("data",))
    runs = []
    for kw in ({}, dict(rules=rules, mesh=mesh)):
        model = from_jax_params(params, pc, device="cpu")
        if kw:
            model = shard_params(model, rules, mesh)
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


@pytest.mark.parametrize("config,micro", [("ds pp", 1), ("rg", 2)])
def test_one_by_one_train_is_the_plain_step_bit_for_bit(one_rank, config,
                                                         micro):
    mesh = one_rank
    _, pc = _cfgs(config)
    params, np_batch = _train_inputs(config)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    plain = from_jax_params(params, pc, device="cpu")
    popt = adamw_init(dict(plain.named_parameters()))
    pstep = make_train_step(pc, microbatches=micro, **STEP_KW)
    rules = ShardingRules(data_axes=("data",))
    sharded = shard_params(from_jax_params(params, pc, device="cpu"), rules,
                           mesh)
    sopt = adamw_init(dict(sharded.named_parameters()))
    sstep = make_train_step(pc, rules, mesh, microbatches=micro, **STEP_KW)
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


def test_shard_params_frees_the_full_tensors(one_rank):
    """After ``shard_params`` no reference to a replaced parameter stays
    (a weakref to each dies), and a split leaf's shard has a storage of
    its own, of the shard's bytes: nothing holds the full tensors of the
    leaves it splits. A replicated leaf's DTensor holds the full tensor's
    storage itself."""
    from torch.distributed.tensor import Replicate
    mesh = one_rank
    _, pc = _cfgs("rg pp")
    model = from_jax_params(_serve_inputs("rg pp")[0], pc, device="cpu")
    old = {k: (weakref.ref(p), p.untyped_storage().data_ptr())
           for k, p in model.named_parameters()}
    shard_params(model, ShardingRules(data_axes=("data",)), mesh)
    gc.collect()
    alive = sorted(k for k, (ref, _) in old.items() if ref() is not None)
    assert not alive, alive
    split = 0
    for k, p in model.named_parameters():
        local = p.to_local()
        if all(isinstance(pl, Replicate) for pl in p.placements):
            assert local.untyped_storage().data_ptr() == old[k][1], k
            continue
        split += 1
        assert local.untyped_storage().data_ptr() != old[k][1], k
        assert local.untyped_storage().nbytes() == \
            local.numel() * local.element_size(), k
    assert split > 0
