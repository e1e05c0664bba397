"""The port's tensor-parallel serving steps (``launch.steps.make_prefill``
and ``make_serve_step`` with rules and a mesh) on gloo ranks, in float32,
from the JAX ``init`` weights, against the JAX reference's *unsharded*
``repro.launch.steps`` prefill and serve step on the same weights:

  * a prompt of 12 tokens at B 4, the clocks then staggered to 12, 11, 10
    and 9 (slots at both SOI phases; rows past a slot's clock masked), and
    8 greedy steps; qwen3 smoke pp and fp, h2o-danube-1.8b's smoke config
    (window-8 rings, which wrap) and nemotron-4-15b's (LayerNorm, squared
    ReLU) pp, max_len 32:
      - on a 1 x 2 and a 2 x 2 (data x model) mesh: every ring's rows
        split over the model axis (ring slots [r S/2, (r+1) S/2) of every
        KV head on rank r);
      - on a 1 x 4 mesh, the same four at 8 query / 4 KV heads (the smoke
        configs' 2 KV heads do not split over 4 ranks, a layout the step
        refuses);
      - max_len 31 on 1 x 2 (the outer rings of 31 rows stay whole on each
        rank, the middle's 16 split) and max_len 30 on 1 x 4 (every ring
        whole);
    greedy tokens equal the reference's and the logits are within ``ATOL``
    of its logits at every step; every rank's state leaves have the local
    shapes and dtypes of ``decode_state_specs`` of the global state and
    its bytes equal ``per_device_bytes`` (the dry run's ``decode_state``
    count); the gathered state equals the port's unsharded steps' within
    ``ATOL``, positions and clocks exactly;
  * the refusal on 1 x 2 of a serve step without ``max_len``; RWKV, the
    encoder-decoder and the prefix-LM, refused there until they ran,
    build (their runs: ``tests/test_torch_sharded_families.py``; the MoE
    stacks': ``tests/test_torch_sharded_moe.py``);
  * the MLA (deepseek-v2 smoke pp, MLA + MoE) and RG-LRU (recurrentgemma
    smoke, MQA) stacks, which the steps refused before they ran them,
    from seed-0 weights on 1 x 2: the prefill and two greedy steps
    against the plain port steps in each rank, tokens equal and logits
    within ``ATOL`` (their parity with the JAX reference:
    ``tests/test_torch_sharded_mla_rglru.py``);
  * a one-process 1 x 1 gloo world, bit for bit the plain steps.

Two spawns (2 and 4 ranks) run every case (``_torch_ranks``).
"""

import dataclasses
import functools
import importlib

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
from repro.models import transformer as JT
from repro_torch import configs as pconfigs
from repro_torch.convert import from_jax_params
from repro_torch.distributed.sharding import ShardingRules, shard_params
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_prefill, make_serve_step

torch.set_num_threads(1)

ATOL = 5e-4                  # port vs JAX serving (PERF.md §2)
B, PROMPT, STEPS = 4, 12, 8
STAGGER = np.array([0, 1, 2, 3], np.int32)
ARCHS = {"qwen3": "qwen3_1_7b", "danube": "h2o_danube_1_8b",
         "nemotron": "nemotron_4_15b"}
CONFIGS = {"qwen3 pp": ("qwen3", "pp"), "qwen3 fp": ("qwen3", "fp"),
           "danube": ("danube", None), "nemotron pp": ("nemotron", "pp")}
# name: (config, mesh, max_len, 8/4 heads)
CASES = {}
for _mesh, _wide in (((1, 2), False), ((2, 2), False), ((1, 4), True)):
    for _c in CONFIGS:
        CASES[f"{_c} {_mesh[0]}x{_mesh[1]}"] = (_c, _mesh, 32, _wide)
CASES["qwen3 pp 1x2 ring 31"] = ("qwen3 pp", (1, 2), 31, False)
CASES["qwen3 pp 1x4 ring 30"] = ("qwen3 pp", (1, 4), 30, True)


def _wide_heads(cfg):
    """``cfg`` at 8 query heads over 4 KV heads (head width unchanged)."""
    segs = tuple(dataclasses.replace(seg, blocks=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(
            b.attn, n_heads=8, n_kv=4)) for b in seg.blocks))
        for seg in cfg.segments)
    return dataclasses.replace(cfg, segments=segs)


@functools.lru_cache(maxsize=None)
def _cfgs(config, wide):
    arch, mode = CONFIGS[config]
    out = []
    for pkg in ("repro.configs", "repro_torch.configs"):
        m = importlib.import_module(f"{pkg}.{ARCHS[arch]}")
        c = dataclasses.replace(m.smoke_config(soi=mode), dtype="float32")
        out.append(_wide_heads(c) if wide else c)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights(config, wide):
    jc, _ = _cfgs(config, wide)
    params, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (B, PROMPT)).astype(np.int32)
    return jax.tree.map(np.asarray, params), tokens


@functools.lru_cache(maxsize=None)
def _reference(config, wide, max_len):
    """The JAX unsharded prefill, the staggered clocks and the greedy
    steps: (logits of every step, tokens fed)."""
    jc, _ = _cfgs(config, wide)
    params, tokens = _weights(config, wide)
    jp = jax.tree.map(jnp.asarray, params)
    logits, state = jax.jit(jmake_prefill(jc, max_len=max_len))(
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


def _refuse_cfgs():
    return {a: pconfigs.get_smoke(a) for a in (
        "rwkv6-1.6b", "whisper-tiny", "paligemma-3b")}


# once refused on 1 x 2, now built (their runs:
# tests/test_torch_sharded_families.py; olmoe-1b-7b's MoE stack:
# tests/test_torch_sharded_moe.py)
REFUSED = {"rwkv6-1.6b": "RWKV", "whisper-tiny": "encoder-decoder",
           "paligemma-3b": "prefix-LM"}
# the stacks the steps refused before this layout ran them
RUNS = {"MLA": ("deepseek-v2-236b", "pp"), "RG-LRU": ("recurrentgemma-9b",
                                                       None)}


def _run_cfgs():
    return {name: dataclasses.replace(pconfigs.get_smoke(arch, soi=mode),
                                      dtype="float32")
            for name, (arch, mode) in RUNS.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sharded_serve_{world}")
        cases = {}
        for name, (config, mesh, ml, wide) in CASES.items():
            if mesh[0] * mesh[1] != world:
                continue
            params, tokens = _weights(config, wide)
            cases[name] = dict(cfg=_cfgs(config, wide)[1], mesh=mesh,
                               max_len=ml, params=params, tokens=tokens,
                               stagger=STAGGER, steps=STEPS)
        inp = {"cases": cases}
        if world == 2:
            inp["refuse_cfgs"] = _refuse_cfgs()
            inp["max_len_cfg"] = _cfgs("qwen3 pp", False)[1]
            inp["run_cfgs"] = _run_cfgs()
            inp["run_tokens"] = np.random.default_rng(2).integers(
                0, 256, (B, PROMPT)).astype(np.int32)
        R._save(tmp, "serve_in.pkl", inp)
        R.spawn(world, "serve", tmp)
        out.update(R.load(tmp, "serve_out.pkl"))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serve_matches_the_jax_unsharded_steps(run, name):
    config, _, ml, wide = CASES[name]
    got = run[name]
    want_logits, want_tokens = _reference(config, wide, ml)
    assert len(got["tokens"]) == len(want_tokens) == STEPS
    for step, (g, w) in enumerate(zip(got["tokens"], want_tokens)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {step}")
    for step, (g, w) in enumerate(zip(got["logits"], want_logits)):
        assert g.shape == w.shape == (B, w.shape[1])
        err = float(np.max(np.abs(g - w)))
        assert err < ATOL, (step, err)


@pytest.mark.parametrize("name", list(CASES))
def test_state_shards_have_the_specs_layout(run, name):
    _, mesh, ml, _ = CASES[name]
    got = run[name]
    assert len(got["ranks"]) == mesh[0] * mesh[1]
    for r, rank in enumerate(got["ranks"]):
        bad = sorted(k for k, ok in rank["shapes_ok"].items() if not ok)
        assert not bad, (r, bad)
        assert rank["dtypes_ok"], r
        assert rank["bytes"] == rank["per_device_bytes"], r
    split = set(got["split"])
    kv = {k for k in got["state"] if k.rsplit(".", 1)[-1] in
          ("k", "v", "pos")}
    if ml == 32:                    # every ring's rows split
        assert split == kv
    elif ml == 31:                  # the middle's 16 rows split, not 31
        assert split == {k for k in kv if k.startswith("mid.")}
    else:                           # 30 and 15 rows: whole on every rank
        assert not split


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_state_is_the_unsharded_steps(run, name):
    """The port's unsharded prefill and steps fed the same tokens; the
    gathered state within ``ATOL``, positions and clocks exactly."""
    config, _, ml, wide = CASES[name]
    got = run[name]
    _, pc = _cfgs(config, wide)
    params, tokens = _weights(config, wide)
    model = from_jax_params(params, pc, device="cpu")
    _, state = make_prefill(pc, max_len=ml)(model,
                                            {"tokens": torch.from_numpy(
                                                tokens)})
    state["t"].sub_(torch.from_numpy(STAGGER))
    step = make_serve_step(pc)
    for tok in got["tokens"]:
        step(model, state, torch.from_numpy(tok))
    want = S.flatten(state)
    assert set(want) == set(got["state"])
    for k, w in want.items():
        g = got["state"][k]
        assert g.shape == tuple(w.shape), k
        if w.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=k)
        else:
            assert float(np.max(np.abs(g - w.numpy()))) < ATOL, k


def test_refusals(run):
    """A serve step on 1 x 2 without ``max_len`` stays refused; the
    RWKV, encoder-decoder and prefix-LM stacks build both steps."""
    refused = run["refused"]
    assert set(refused) == {f"{a} {s}" for a in REFUSED
                            for s in ("serve", "prefill")} | {
        "qwen3 no max_len"}
    for arch in REFUSED:
        for s in ("serve", "prefill"):
            assert refused[f"{arch} {s}"] is None, (arch, s)
    assert "needs max_len" in refused["qwen3 no max_len"]


@pytest.mark.parametrize("stack", list(RUNS))
def test_mla_and_rglru_stacks_serve_on_the_mesh(run, stack):
    """Once refused, now served: the prefill and two steps on 1 x 2 give
    the plain steps' tokens, logits within ``ATOL``."""
    same_tokens, err = run["runs"][stack]
    assert same_tokens, stack
    assert err < ATOL, (stack, err)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("config", ["qwen3 pp", "danube"])
def test_one_by_one_is_the_plain_steps_bit_for_bit(one_rank, config):
    mesh = one_rank
    _, pc = _cfgs(config, False)
    params, tokens = _weights(config, False)
    batch = {"tokens": torch.from_numpy(tokens)}
    plain = from_jax_params(params, pc, device="cpu")
    rules = ShardingRules(data_axes=("data",))
    sharded = shard_params(from_jax_params(params, pc, device="cpu"), rules,
                           mesh)
    runs = []
    for model, kw in ((plain, {}), (sharded, dict(rules=rules, mesh=mesh))):
        logits, state = make_prefill(pc, max_len=32, **kw)(model, batch)
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
