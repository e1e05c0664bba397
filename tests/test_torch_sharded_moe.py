"""Expert parallelism: the port's MoE stacks through the sharded
``launch.steps`` (``make_prefill``, ``make_serve_step``, ``make_train_step``
with rules and a mesh) on gloo ranks, in float32, against the JAX
reference's *unsharded* steps on the same numpy weights. The router's
columns and the experts split over the model axis, the shared experts on
``ff``, as ``sharding.shard_params`` lays them out:

  * serving — olmoe-1b-7b smoke (8 experts, top 2) SOI pp and plain on 1 x
    2, 2 x 2 and 1 x 4 (data x model) meshes, and pp with a shared expert
    (``n_shared=1, d_shared=48``) on 2 x 2: a 12-token prompt at B 4, the
    clocks staggered to 12, 11, 10 and 9, then 8 greedy steps, max_len 32,
    from the JAX ``init`` weights; greedy tokens equal the reference's,
    logits within ``ATOL`` at every step, every rank's state leaves of
    ``decode_state_specs``' local shapes and bytes;
  * training — olmoe smoke pp on 2 x 2, 1 x 4 and 4 x 1 at microbatches 1
    and 2, and with the shared expert on 2 x 2, at B 8 x S 32, targets
    masked unevenly across the data ranks: three steps held after each to
    the jitted JAX unsharded ``make_train_step`` — metrics (loss, xent,
    aux, grad norm, lr) to ``TOL`` at the first step and 10 x ``TOL``
    after, params and moments to ``BOUNDS``, ``aux`` the global value (not
    0) at one microbatch. B 8 x S 32 puts 8 tokens in each of the global
    microbatch's 32 dispatch groups (4 in the SOI middle's, and in a
    microbatch's), against the 4, 2 or 1 a data rank's own gcd would give,
    and the capacity of 2 drops entries: the count of dropped entries
    (from each MoE layer's input, in numpy) is above 0. At the smoke
    config's k = 2 a group of at most 2 tokens never drops (an expert
    takes one entry a token, and the capacity is at least k), so at B 4 x
    S 16 a wrong grouping could not show;
  * every rank's parameter-shard bytes equal ``per_device_bytes`` of the
    specs (the dry run's ``params`` count) on each mesh;
  * the refusal: on a 3 x 1 mesh the 32 groups of a B 6 x S 16 batch do
    not split over 3 data ranks (``NotImplementedError`` naming
    ROADMAP.md), training and prefill;
  * a one-process 1 x 1 gloo world, bit for bit the plain port steps.

Two spawns (2 and 4 ranks, at once) run every case (``_torch_ranks``'
``moe`` job), while this process computes the JAX references.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks as R
import repro.configs.olmoe_1b_7b as JO
from repro.distributed.sharding import split_axes
from repro.launch.steps import make_prefill as jmake_prefill
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import olmoe_1b_7b as PO
from repro_torch.convert import from_jax_params
from repro_torch.distributed.sharding import (ShardingRules, gather_params,
                                              gather_tree, shard_params)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (local_batch, make_prefill,
                                      make_serve_step, make_train_step)
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw_init
from test_torch_train import BOUNDS, STEP_KW, TOL, _by_name, _rel, _share_off
from test_torch_train_families import _random_params as _family_params

torch.set_num_threads(1)

ATOL = 5e-4                  # port vs JAX serving (PERF.md §2)
B, PROMPT, STEPS, MAX_LEN = 4, 12, 8, 32
STAGGER = np.array([0, 1, 2, 3], np.int32)
TB, TS, TRAIN_STEPS = 8, 32, 3
# config: (SOI mode, a shared expert)
CONFIGS = {"pp": ("pp", False), "plain": (None, False),
           "shared pp": ("pp", True)}
SERVE = {f"{c} {m[0]}x{m[1]}": (c, m) for c in ("pp", "plain")
         for m in ((1, 2), (2, 2), (1, 4))}
SERVE["shared pp 2x2"] = ("shared pp", (2, 2))
TRAIN = {f"pp {m[0]}x{m[1]} micro {mb}": ("pp", m, mb)
         for m in ((2, 2), (1, 4), (4, 1)) for mb in (1, 2)}
TRAIN["shared pp 2x2 micro 1"] = ("shared pp", (2, 2), 1)
BYTES = {f"{c} {m[0]}x{m[1]}": (c, m) for c in ("pp", "shared pp")
         for m in ((1, 2), (2, 2), (1, 4), (4, 1))}


def _with_shared(cfg):
    """``cfg`` with one shared expert of width 48 in every MoE layer."""
    segs = tuple(dataclasses.replace(seg, blocks=tuple(
        dataclasses.replace(b, moe=dataclasses.replace(
            b.moe, n_shared=1, d_shared=48)) for b in seg.blocks))
        for seg in cfg.segments)
    return dataclasses.replace(cfg, segments=segs)


@functools.lru_cache(maxsize=None)
def _cfgs(config):
    mode, shared = CONFIGS[config]
    out = []
    for m in (JO, PO):
        c = dataclasses.replace(m.smoke_config(soi=mode), dtype="float32")
        out.append(_with_shared(c) if shared else c)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _serve_inputs(config):
    jc, _ = _cfgs(config)
    params, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (B, PROMPT)).astype(np.int32)
    return jax.tree.map(np.asarray, params), tokens


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
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sharded_moe_{world}")
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
        if world == 4:
            inp["refuse"] = (_cfgs("pp")[1], np.zeros((6, 16), np.int32))
        R._save(tmp, "moe_in.pkl", inp)
        procs.append((tmp, R.spawn(world, "moe", tmp, join=False)))
    try:
        for config in CONFIGS:
            _serve_reference(config)
        for config, _, micro in TRAIN.values():
            _train_reference(config, micro)
    finally:
        for _, ctx in procs:
            R.wait(ctx)
    out = {}
    for tmp, _ in procs:
        got = R.load(tmp, "moe_out.pkl")
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
    params, moments, the sum of the learning rates)."""
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


def _dropped(config, rows: int) -> int:
    """Entries the MoE layers drop on the first ``rows`` rows of the
    training batch, counted in numpy from each layer's input in the
    unsharded port's forward: per dispatch group (``gcd(T, 32)`` of them)
    and expert, the top-k entries past the capacity."""
    _, pc = _cfgs(config)
    params, batch = _train_inputs(config)
    model = from_jax_params(params, pc, device="cpu")
    seen = []
    real = PT.moe_apply

    def spy(p, x, **kw):
        seen.append((p.router.detach().numpy(),
                     x.detach().reshape(-1, x.shape[-1]).numpy(), p.cfg))
        return real(p, x, **kw)

    PT.moe_apply = spy
    try:
        with torch.no_grad():
            PT.loss_sums(model, pc, {k: torch.from_numpy(v[:rows])
                                     for k, v in batch.items()})
    finally:
        PT.moe_apply = real
    assert seen
    drops = 0
    for router, xt, mc in seen:
        t, k, e = xt.shape[0], mc.top_k, mc.n_experts
        r = math.gcd(t, 32)
        tg = t // r
        cap = max(k, int(tg * k / e * mc.capacity_factor))
        top = np.argsort(-(xt @ router), axis=-1, kind="stable")[:, :k]
        for g in range(r):
            counts = np.bincount(top[g * tg:(g + 1) * tg].ravel(),
                                 minlength=e)
            drops += int(np.maximum(counts - cap, 0).sum())
    return drops


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_moe_serve_matches_the_jax_unsharded_steps(run, name):
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
def test_moe_state_shards_have_the_specs_layout(run, name):
    _, mesh = SERVE[name]
    got = run["serve"][name]
    assert len(got["ranks"]) == math.prod(mesh)
    for r, rank in enumerate(got["ranks"]):
        bad = sorted(k for k, ok in rank["shapes_ok"].items() if not ok)
        assert not bad, (r, bad)
        assert rank["dtypes_ok"], r
        assert rank["bytes"] == rank["per_device_bytes"], r
    kv = {k for k in got["state"] if k.rsplit(".", 1)[-1] in
          ("k", "v", "pos")}
    assert set(got["split"]) == kv          # every ring's rows split


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_moe_train_matches_the_jax_unsharded_step(run, name):
    config, _, micro = TRAIN[name]
    got = run["train"][name]
    want, params, moments, lr_sum, count = _train_reference(config, micro)
    for step, (pm, jm) in enumerate(zip(got["metrics"], want)):
        assert set(pm) == set(jm)
        for k in jm:
            assert _rel(pm[k], jm[k]) < (TOL if step == 0 else 10 * TOL), \
                (step, k, pm[k], jm[k])
        # the global aux at one microbatch; the reference's 0 at more
        assert (pm["aux"] > 0) == (micro == 1), (step, pm["aux"])
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
    assert _dropped(config, TB // micro) > 0


@pytest.mark.parametrize("name", list(BYTES))
def test_param_shards_have_the_dry_runs_bytes(run, name):
    ranks = run["bytes"][name]
    _, mesh = BYTES[name]
    assert len(ranks) == math.prod(mesh)
    full = sum(t.numel() * 4 for t in
               S.abstract_params(_cfgs(BYTES[name][0])[1])[0].values())
    for r, (got, want) in enumerate(ranks):
        assert got == want, (r, got, want)
    if mesh[1] > 1:                     # the experts split: a rank holds less
        assert ranks[0][0] < full


def test_groups_that_do_not_split_over_the_data_ranks_are_refused(run):
    refused = run["refused"]
    assert set(refused) == {"train", "prefill"}
    for what, msg in refused.items():
        assert msg is not None and "ROADMAP.md" in msg, what
        assert "do not split over 3 data ranks" in msg, what
        assert "Queue 1 item 8" in msg, what


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("config", ["pp", "shared pp"])
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


@pytest.mark.parametrize("config,micro", [("pp", 1), ("pp", 2),
                                          ("shared pp", 1)])
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
        assert (float(sm["aux"]) > 0) == (micro == 1)
    want = dict(plain.named_parameters())
    for k, v in gather_params(sharded).items():
        assert torch.equal(v, want[k].detach()), k
    for t in ("mu", "nu"):
        for k, v in gather_tree(sopt[t]).items():
            assert torch.equal(v, popt[t][k]), (t, k)
