"""The port's data x tensor-parallel train step (``launch.steps
.make_train_step`` with rules and a mesh) on gloo ranks, qwen3 smoke (4
layers, d 64, 4/2 heads, vocab 256) in float32:

  * a 2 x 2 (data x model) world, SOI none and pp, microbatches 2, a 4 x 1
    world with int8 compression, and nemotron-4-15b's smoke (LayerNorm
    with biases, squared ReLU; pp, 2 x 2): three steps on the same batch,
    with targets masked unevenly across the data ranks (a step that
    averaged per-rank means would be off), held after each step to the
    jitted JAX *unsharded* ``repro.launch.steps.make_train_step`` on the
    same numpy weights — the metrics to ``TOL`` at the first step and 10
    x ``TOL`` after, the gathered params and moments (and error state) to
    ``BOUNDS`` (``tests/test_torch_train.py``) — and the loss falls, the
    reference's own assertion (``tests/test_sharding.py``). One spawn of 4
    ranks runs every case (``_torch_ranks``);
  * a one-process 1 x 1 gloo world, bit for bit the plain port step (loss,
    grad norm, params and moments), microbatches 1 and 2, SOI none and pp;
  * the refusals: compression on a split model axis and with fsdp over 2
    data ranks, kv heads that neither divide the model axis nor are
    divided by it (3 on 4 ranks; training and serving), whisper-tiny's 6
    heads on 4 ranks, and a CUDA mesh without a card; fsdp and seq_shard,
    once refused, build (their runs: ``tests/test_torch_sharded_fsdp_sp
    .py``), and so do the three steps of RWKV, the encoder-decoder and the
    prefix-LM — whisper-tiny at its published width, its vocab of 51865
    whole on every rank — (their runs:
    ``tests/test_torch_sharded_families.py``);
  * the MLA (deepseek-v2 smoke pp, MLA + MoE) and RG-LRU (recurrentgemma
    smoke, MQA's KV head replicated) stacks, which the step refused before
    it ran them, from seed-0 weights on the 2 x 2 mesh: one sharded step
    against the plain port step in each rank (their parity with the JAX
    reference: ``tests/test_torch_sharded_mla_rglru.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks as R
import repro.configs.nemotron_4_15b as JNM
import repro.configs.qwen3_1_7b as Q
from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as pconfigs
from repro_torch.configs import nemotron_4_15b as PNM
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.distributed.sharding import (ShardingRules, gather_params,
                                              gather_tree, shard_params)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import local_batch, make_train_step
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw_init
from test_torch_train import (BOUNDS, STEP_KW, TOL, _by_name, _random_params,
                              _rel, _share_off)
from test_torch_train_families import _random_params as _family_params

torch.set_num_threads(1)

WORLD, B, S, STEPS = 4, 8, 16, 3
# name: (SOI mode, mesh, compress, arch module pair, weight draw)
CASES = {"none 2x2": (None, (2, 2), False, (Q, PQ), _random_params),
         "pp 2x2": ("pp", (2, 2), False, (Q, PQ), _random_params),
         "none 4x1 compress": (None, (4, 1), True, (Q, PQ), _random_params),
         # LayerNorm (its biases replicated) and the squared-ReLU MLP split
         # over the model axis; drawn at test_torch_train_families.py's
         # gains, as its training is held there: at gain 1 the unsharded
         # port's and the reference's grad norms already differ by 2e-5,
         # float32 rounding (test_gain_one_rounding_is_alike)
         "nemotron pp 2x2": ("pp", (2, 2), False, (JNM, PNM),
                             _family_params)}


def _cfgs(mode, mods=(Q, PQ)):
    return tuple(dataclasses.replace(m.smoke_config(soi=mode),
                                     dtype="float32") for m in mods)


def _family_cfgs():
    """The stacks the steps refused on more than one rank until they ran
    them: rwkv6 and paligemma smoke, and whisper-tiny at full width."""
    from repro_torch.configs import whisper_tiny
    return {"rwkv6-1.6b": pconfigs.get_smoke("rwkv6-1.6b", soi="pp"),
            "paligemma-3b": pconfigs.get_smoke("paligemma-3b"),
            "whisper-tiny": whisper_tiny.config()}


def _kv3_cfg():
    """qwen3 smoke (plain) at 12 query / 3 KV heads: 4 ranks neither
    divide 3 KV heads nor are divided by them."""
    cfg = _cfgs(None)[1]
    segs = tuple(dataclasses.replace(seg, blocks=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(
            b.attn, n_heads=12, n_kv=3)) for b in seg.blocks))
        for seg in cfg.segments)
    return dataclasses.replace(cfg, segments=segs)


def _stack_cfgs():
    """The MLA and RG-LRU stacks the step runs since it stopped refusing
    them: deepseek-v2 smoke pp (MLA + MoE) and recurrentgemma smoke."""
    from repro_torch.configs import deepseek_v2_236b as PDS
    from repro_torch.configs import recurrentgemma_9b as PRG
    return {"MLA": dataclasses.replace(PDS.smoke_config(soi="pp"),
                                       dtype="float32"),
            "RG-LRU": dataclasses.replace(PRG.smoke_config(),
                                          dtype="float32")}


def _batch(vocab):
    """Next-token targets; rows 0, 1 and 4 — data rank 0's on both meshes
    — lose most of their targets, the others none."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[0, :12] = -1
    targets[1, :10] = -1
    targets[4, :9] = -1
    return {"tokens": tokens, "targets": targets}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    cases = {}
    for name, (mode, mesh, compress, mods, draw) in CASES.items():
        jc, pc = _cfgs(mode, mods)
        cases[name] = dict(
            cfg=pc, mesh=mesh, params=draw(jc), steps=STEPS,
            batch=_batch(jc.vocab),
            step_kw=dict(microbatches=2, compress=compress, **STEP_KW))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, (4, 16)).astype(np.int32)
    R._save(tmp, "train_in.pkl", {
        "cases": cases, "refuse_cfg": _cfgs(None)[1], "kv3_cfg": _kv3_cfg(),
        "family_cfgs": _family_cfgs(),
        "run_cfgs": _stack_cfgs(),
        "run_batch": {"tokens": tokens,
                      "targets": np.roll(tokens, -1, axis=1)}})
    R.spawn(WORLD, "train", tmp)
    return cases, R.load(tmp, "train_out.pkl")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_jax_unsharded_step(run, name):
    cases, out = run
    mode, _, compress, mods, _ = CASES[name]
    case, got = cases[name], out[name]
    jc, pc = _cfgs(mode, mods)
    jparams = jax.tree.map(jnp.asarray, case["params"])
    jstep = jax.jit(jmake_train_step(jc, **case["step_kw"]))
    jopt = jadamw_init(jparams)
    jbatch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    lr_sum = 0.0
    for step in range(STEPS):
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        pm = got["metrics"][step]
        assert set(pm) == set(jm)
        for k in jm:
            assert _rel(pm[k], jm[k]) < (TOL if step == 0 else 10 * TOL), \
                (step, k)
        lr_sum += float(jm["lr"])
    assert got["metrics"][-1]["loss"] < got["metrics"][0]["loss"]
    assert got["count"] == int(jopt["count"]) == STEPS
    assert ("err" in got) == compress
    trees = {"params": (got["params"], _by_name(jparams, pc))}
    trees.update({t: (got[t], _by_name(jopt[t], pc))
                  for t in BOUNDS[compress] if t != "params"})
    for t, (g, w) in trees.items():
        assert set(g) == set(w), t
        bound, share = BOUNDS[compress][t]
        assert _share_off(g, w, bound) <= share, t
    g, w = trees["params"]
    for k in w:
        assert float(np.abs(g[k] - w[k]).max()) <= lr_sum, k


def test_refusals(run):
    """fsdp and seq_shard build (train, prefill, serve); compression with
    fsdp over 2 data ranks joins the refusals."""
    _, out = run
    refused = out["refused"]
    built = {"fsdp", "seq_shard", "serve fsdp seq_shard", "prefill seq_shard"}
    built |= {f"{a} {s}" for a in _family_cfgs()
              for s in ("train", "prefill", "serve")}
    assert set(refused) == built | {"compress", "compress fsdp", "kv_heads",
                                    "serve kv_heads", "prefill kv_heads",
                                    "heads"}
    for name, msg in refused.items():
        if name in built:
            assert msg is None, (name, msg)
        else:
            assert msg is not None and "ROADMAP.md" in msg, name
    assert "compress=True with fsdp over 2 data ranks" in \
        refused["compress fsdp"]
    assert "model axis of 2" in refused["compress"]
    for name in ("kv_heads", "serve kv_heads", "prefill kv_heads"):
        assert "model axis of 4" in refused[name], name
        assert "'kv_heads' dim 3" in refused[name], name
    assert "'heads' dim 6 % mesh 4" in refused["heads"]
    assert "Queue 1 item 8" in refused["heads"]


@pytest.mark.parametrize("stack", ["MLA", "RG-LRU"])
def test_mla_and_rglru_stacks_train_on_the_mesh(run, stack):
    """Once refused, now run: one step on the 2 x 2 mesh, its metrics
    within ``TOL`` of the plain step's."""
    _, out = run
    got = out["runs"][stack]
    assert set(got) == {"loss", "xent", "aux", "grad_norm", "lr"}
    for k, (sharded, plain) in got.items():
        assert _rel(sharded, plain) < TOL, (k, sharded, plain)
    assert (got["aux"][1] > 0) == (stack == "MLA")


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("mode,micro", [(None, 1), ("pp", 2)])
def test_one_by_one_is_the_plain_step_bit_for_bit(one_rank, mode, micro):
    mesh = one_rank
    jc, pc = _cfgs(mode)
    weights = _random_params(jc)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pc.vocab).items()}
    from repro_torch.convert import from_jax_params
    plain = from_jax_params(weights, pc, device="cpu")
    popt = adamw_init(dict(plain.named_parameters()))
    pstep = make_train_step(pc, microbatches=micro, **STEP_KW)
    rules = ShardingRules(data_axes=("data",))
    sharded = shard_params(from_jax_params(weights, pc, device="cpu"), rules,
                           mesh)
    sopt = adamw_init(dict(sharded.named_parameters()))
    sstep = make_train_step(pc, rules, mesh, microbatches=micro, **STEP_KW)
    for _ in range(STEPS):
        _, _, pm = pstep(plain, popt, batch)
        _, _, sm = sstep(sharded, sopt, local_batch(batch, mesh, micro))
        for k in pm:
            assert torch.equal(pm[k], sm[k]), k
    want = dict(plain.named_parameters())
    for k, v in gather_params(sharded).items():
        assert torch.equal(v, want[k].detach()), k
    for t in ("mu", "nu"):
        for k, v in gather_tree(sopt[t]).items():
            assert torch.equal(v, popt[t][k]), (t, k)
    assert torch.equal(sopt["count"], popt["count"])


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))


def test_sharded_loss_is_the_plain_loss_on_one_rank(one_rank):
    """``loss_sums`` inside ``model_parallel`` over one rank: the plain
    path's NLL and count bit for bit (the hooks are the identity)."""
    from repro_torch.models.layers import model_parallel
    jc, pc = _cfgs("pp")
    model = PT.init(pc, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(pc.vocab).items()}
    want = PT.loss_sums(model, pc, batch)
    with model_parallel(one_rank.get_group("model")):
        got = PT.loss_sums(model, pc, batch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_logical_constraint_and_make_constrain(one_rank):
    """``logical_constraint`` lays a DTensor out by its logical axes (rows
    over the data axis); without a mesh it and ``make_constrain``'s
    function are the identity."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.sharding import logical_constraint
    from repro_torch.launch.steps import make_constrain
    mesh = one_rank
    rules = ShardingRules(data_axes=("data",))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 6)).astype(np.float32))
    dx = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    y = logical_constraint(dx, ("batch", "embed_act"), rules, mesh)
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert torch.equal(y.full_tensor(), x)
    z = make_constrain(rules, mesh)(dx, ("batch", "embed_act"))
    assert tuple(z.placements) == (Shard(0), Replicate())
    assert logical_constraint(x, ("batch", None), rules, None) is x
    assert make_constrain(None, None)(x, ("batch", None)) is x
