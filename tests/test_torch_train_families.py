"""Training of the MoE, MLA, RG-LRU and windowed-attention stacks against
the JAX reference on the CPU, at smoke width in float32:

  * ``loss_fn``'s value, its ``xent`` and ``aux`` (the MoE routers'
    load-balancing loss, summed over every MoE layer, the SOI middle's
    included) and the gradient of every parameter against
    ``jax.value_and_grad(repro.models.transformer.loss_fn)`` on the same
    numpy weights, within 1e-5 of each leaf's largest |value|: olmoe-1b-7b
    (MoE, SOI pp), deepseek-v2 (MLA + MoE, no SOI and pp),
    recurrentgemma-9b (RG-LRU and window-8 attention at S 16) and
    h2o-danube-1.8b (window 8 at S 16);
  * three ``make_train_step`` steps of deepseek-v2 against the jitted JAX
    step at microbatches 1 and 2 (the reference's metrics: ``xent`` the
    mean total and ``aux`` 0 when microbatched);
  * at gain 1 (``tests/test_torch_train.py``'s draw) every leaf's float32
    gradient, the port's and the reference's, about equally far (within
    10x of each other) from a float64 run of the port — the check that
    ``GAIN`` rests on;
  * recurrentgemma-9b smoke pp's train step at B 8 x S 32 (the batch of
    ``tests/test_torch_sharded_mla_rglru.py``), which is past ``BOUNDS``
    from the jitted JAX step from its second step: its first gradients
    round as the reference's do (within 10x, leaf by leaf, of a float64
    run of the port), and after three steps the port's params and first
    moments are no further from a float64 run of the port's step than the
    reference's (within 10x) — a named difference, not a fault;
  * the MLA, RG-LRU, RWKV, encoder-decoder and prefix-LM stacks, which the
    mesh steps refused until they ran them, pass the steps' layout check
    without a process group (``tests/test_torch_sharded_mla_rglru.py``
    and ``tests/test_torch_sharded_families.py`` run them on gloo ranks),
    and olmoe's MoE stack built and run on a 2 x 2 and a 1 x 1 gloo
    mesh.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed.sharding import split_axes
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as pconfigs
from repro_torch.convert import from_jax_params
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw_init
from test_torch_train import _random_params as _gain1_params

torch.set_num_threads(1)

TOL = 1e-5
B, S = 4, 16
STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=10)
# (arch, SOI mode): every family this slice trains
CASES = [("olmoe-1b-7b", "pp"), ("deepseek-v2-236b", None),
         ("deepseek-v2-236b", "pp"), ("recurrentgemma-9b", None),
         ("h2o-danube-1.8b", None)]


def _cfgs(arch, mode):
    jmod = importlib.import_module(jconfigs._MODULES[arch])
    return (dataclasses.replace(jmod.smoke_config(soi=mode),
                                dtype="float32"),
            dataclasses.replace(pconfigs.get_smoke(arch, soi=mode),
                                dtype="float32"))


# The float32 rounding of a gradient grows with the activations it runs
# through (RMSNorm, the RG-LRU's sqrt(1 - a^2) gate, softmaxes): at the
# draw of tests/test_torch_train.py (qwen3, gain 1) the danube, deepseek-v2
# and recurrentgemma gradients of either framework sit 1e-4 to 2e-3 of
# their leaf's largest from a float64 run of the port, past TOL —
# ``test_gain_one_rounding_is_alike`` holds the two frameworks equally far
# there. At these gains every family's float32 gradient is within 3e-6 of
# its float64 run, so TOL tests the port, not the rounding.
GAIN = {"matrix": 0.25, "embed": 0.25, "vector": 0.1}


def _random_params(cfg, seed=0):
    """The reference's tree (from an abstract init) with every leaf drawn
    by numpy: fan-in scaled weights, embeddings and nonzero norms, each
    times its ``GAIN``."""
    shapes, _ = split_axes(jax.eval_shape(
        lambda k: JT.init(k, cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(x):
        if len(x.shape) == 1:
            s = GAIN["vector"]
        elif x.shape[0] == cfg.vocab:
            s = GAIN["embed"]
        elif len(x.shape) == 3 and x.shape[-1] == cfg.d_model:
            s = GAIN["matrix"] * float(np.prod(x.shape[:-1])) ** -0.5
        else:
            s = GAIN["matrix"] * x.shape[0] ** -0.5
        return (rng.standard_normal(x.shape) * s).astype(np.float32)

    return jax.tree.map(draw, shapes)


@functools.lru_cache(maxsize=None)
def _setup(arch, mode):
    jc, pc = _cfgs(arch, mode)
    np_params = _random_params(jc)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    targets = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    targets[0, :3] = -1                       # masked positions
    targets[2, -2:] = -1
    return jc, pc, np_params, {"tokens": tokens, "targets": targets}


def _by_name(tree, pc):
    """A reference-layout tree (params, grads or moments) as the port's
    {state_dict name: numpy}."""
    model = from_jax_params(jax.tree.map(np.asarray, tree), pc,
                            device="cpu")
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def _has_moe(cfg) -> bool:
    return any(b.moe is not None for b in PT.layer_blocks(cfg))


@functools.lru_cache(maxsize=None)
def _jax_grad(arch, mode):
    """The reference's loss and gradients, jitted once a config (the
    weights and the batch are arguments)."""
    jc = _cfgs(arch, mode)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jc, b), has_aux=True))


def jax_run(arch, mode, params, batch):
    return _jax_grad(arch, mode)(jax.tree.map(jnp.asarray, params),
                                 {k: jnp.asarray(v)
                                  for k, v in batch.items()})


@pytest.mark.parametrize("arch,mode", CASES)
def test_loss_aux_and_every_grad_match_jax(arch, mode):
    jc, pc, np_params, batch = _setup(arch, mode)
    (jl, jm), jg = jax_run(arch, mode, np_params, batch)
    loss, metrics, got = port_grads(pc, np_params, batch)
    assert _rel(loss, jl) < TOL
    assert _rel(metrics["xent"], jm["xent"]) < TOL
    if _has_moe(pc):
        assert float(metrics["aux"]) > 0
        assert _rel(metrics["aux"], jm["aux"]) < TOL
    else:
        assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    want = _by_name(jg, pc)
    assert set(got) == set(want)
    for k in want:
        assert got[k] is not None, k
        assert _rel(got[k], want[k]) < TOL, k


# ---------------------------------------------------------------------------
# gain 1: both frameworks' float32 rounding against a float64 run
# ---------------------------------------------------------------------------

# |port f32 - port f64| and |JAX f32 - port f64| of a leaf, each over the
# leaf's largest |value|, within RATIO of each other; below FLOOR (a few
# float32 ulps of the leaf's largest) both are rounding alike
RATIO, FLOOR = 10.0, 1e-6


def _naive_attention(q, k, v, *, causal=True, window=None, prefix_len=0,
                     q_offset=0, scale=None, logit_softcap=None):
    """Masked softmax attention in the inputs' dtype (the float64 run's
    attention; GQA by repeating K/V)."""
    sq, sk = q.shape[1], k.shape[1]
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    allow = pref._mask(torch.arange(sq) + q_offset, torch.arange(sk),
                       causal=causal, window=window, prefix_len=prefix_len)
    s = torch.where(allow, s, torch.full_like(s, pref.NEG_INF))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _rope_freqs64(head_dim, *, pct=1.0, theta=1e4, device=None):
    rot = int(head_dim * pct) // 2 * 2
    ar = torch.arange(0, rot, 2, dtype=torch.float64, device=device)
    return 1.0 / (theta ** (ar / rot))


def port_grads(pc, params, batch, dtype=torch.float32):
    """(loss, metrics, {name: grad}) of the port's ``loss_fn`` on the numpy
    weights and batch, the model and the batch's float arrays in
    ``dtype``."""
    model = from_jax_params(params, pc, device="cpu").to(dtype)
    loss, metrics = PT.loss_fn(model, pc, {
        k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
        else torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss, metrics, {k: p.grad for k, p in model.named_parameters()}


def float64_grads(pc, params, batch, monkeypatch) -> dict:
    """The port's gradients run in float64: every ``.float()`` upcast to
    float64, the compute dtype float64, RoPE's frequencies in float64,
    attention and the RG-LRU scan on plain float64 versions."""
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", lambda self, *a, **kw: self.double())
        m.setattr(PT, "_dtype", lambda cfg: torch.float64)
        m.setattr(PL, "rope_freqs", _rope_freqs64)
        m.setattr(ops, "flash_attention", _naive_attention)
        m.setattr(ops, "lru_scan", pref.lru_scan)
        g64 = port_grads(pc, params, batch, torch.float64)[2]
    assert all(g.dtype == torch.float64 for g in g64.values())
    return g64


def _off(got, want64) -> float:
    return (float((got.double() - want64).abs().max())
            / max(float(want64.abs().max()), 1e-300))


def check_rounding_alike(arch, mode, pc, params, batch, monkeypatch):
    """At ``params`` drawn at gain 1: every leaf's float32 gradient, the
    port's and the reference's, off the port's float64 run by amounts
    within RATIO of each other, and some leaf off by more than FLOOR (the
    rounding that made the gains of ``GAIN`` necessary)."""
    jg = {k: torch.from_numpy(v)
          for k, v in _by_name(jax_run(arch, mode, params, batch)[1],
                               pc).items()}
    g32 = port_grads(pc, params, batch)[2]
    g64 = float64_grads(pc, params, batch, monkeypatch)
    worst = FLOOR
    for k, w in g64.items():
        port, ref_ = (max(_off(g[k], w), FLOOR) for g in (g32, jg))
        assert port <= RATIO * ref_ and ref_ <= RATIO * port, (k, port, ref_)
        worst = max(worst, port, ref_)
    assert worst > FLOOR


@pytest.mark.parametrize("arch,mode", CASES)
def test_gain_one_rounding_is_alike(arch, mode, monkeypatch):
    """The reduced ``GAIN`` rests on this: at tests/test_torch_train.py's
    draw (gain 1) the port's and the reference's float32 gradients sit
    equally far (within RATIO) from a float64 run of the port."""
    jc, pc, _, batch = _setup(arch, mode)
    check_rounding_alike(arch, mode, pc, _gain1_params(jc), batch,
                         monkeypatch)


def _steps64(pc, params, batch, steps, monkeypatch) -> tuple:
    """(params, first moments) of ``steps`` plain port train steps run in
    float64 as ``float64_grads`` runs the gradients, the moments and
    AdamW's arithmetic in float64 too."""
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", lambda self, *a, **kw: self.double())
        m.setattr(PT, "_dtype", lambda cfg: torch.float64)
        m.setattr(PL, "rope_freqs", _rope_freqs64)
        m.setattr(ops, "flash_attention", _naive_attention)
        m.setattr(ops, "lru_scan", pref.lru_scan)
        return _port_steps(pc, params, batch, steps, torch.float64)


def _port_steps(pc, params, batch, steps, dtype=torch.float32) -> tuple:
    model = from_jax_params(params, pc, device="cpu").to(dtype)
    step = make_train_step(pc, **STEP_KW)
    opt = adamw_init(dict(model.named_parameters()))
    for t in ("mu", "nu"):
        opt[t] = {k: v.to(dtype) for k, v in opt[t].items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(steps):
        step(model, opt, tb)
    return ({k: p.detach() for k, p in model.named_parameters()},
            opt["mu"])


def test_recurrentgemma_pp_step_rounds_like_the_reference(monkeypatch):
    """ROADMAP.md Queue 3's open check, settled: recurrentgemma-9b smoke
    pp's unsharded train step at B 8 x S 32 (the batch, weights and
    microbatching of ``tests/test_torch_sharded_mla_rglru.py``'s training)
    leaves ``BOUNDS`` of the jitted JAX step from its second step. Its
    first gradients round as the reference's do (``check_rounding_alike``,
    both within 10x of each other off a float64 run of the port), and
    after three steps the port's float32 params and first moments are no
    further from the port's float64 steps than the reference's float32
    steps are (within RATIO, leaf by leaf): AdamW turns both frameworks'
    rounding into whole updates, the reference's no less than the
    port's."""
    arch, mode = "recurrentgemma-9b", "pp"
    jc, pc = _cfgs(arch, mode)
    params = _random_params(jc)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (8, 32)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[0, :24] = -1
    targets[1, :20] = -1
    targets[4, :18] = -1
    batch = {"tokens": tokens, "targets": targets}
    check_rounding_alike(arch, mode, pc, params, batch, monkeypatch)
    steps = 3
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(jmake_train_step(jc, **STEP_KW))
    jopt = jadamw_init(jparams)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(steps):
        jparams, jopt, _ = jstep(jparams, jopt, jbatch)
    ref = [{k: torch.from_numpy(v) for k, v in _by_name(t, pc).items()}
           for t in (jparams, jopt["mu"])]
    port = _port_steps(pc, params, batch, steps)
    want = _steps64(pc, params, batch, steps, monkeypatch)
    for name, p32, j32, w64 in zip(("params", "mu"), port, ref, want):
        for k, w in w64.items():
            p_off, j_off = (max(_off(g[k], w), FLOOR) for g in (p32, j32))
            assert p_off <= RATIO * j_off, (name, k, p_off, j_off)


def test_serving_drops_the_aux():
    """The MoE channel mix computes no aux without a list to append it to
    (the serving paths), and the forward is the same either way."""
    _, pc, np_params, batch = _setup("olmoe-1b-7b", "pp")
    model = from_jax_params(np_params, pc, device="cpu")
    tokens = torch.from_numpy(batch["tokens"])
    terms = []
    with torch.no_grad():
        h_train = PT.trunk(model, pc, tokens, aux=terms)
        h_serve = PT.trunk(model, pc, tokens)
    assert torch.equal(h_train, h_serve)
    assert len(terms) == pc.n_layers            # every layer is MoE
    x = torch.randn(2, 5, pc.d_model)
    from repro_torch.models.moe import moe_apply
    y, aux = moe_apply(model.blocks[0].moe, x, with_aux=False)
    assert aux is None
    assert torch.equal(y, moe_apply(model.blocks[0].moe, x)[0])


# Past the first step AdamW divides each element's moment by its own root
# mean square, so an element whose gradient is ~1e-6 of its leaf's largest
# carries the two frameworks' float32 rounding into an update of the
# learning rate's size: each tree is held element by element to (bound ×
# its leaf's largest |value|) except for a share of its elements, as
# tests/test_torch_train.py holds qwen3's (BOUNDS there, without
# compression), and the params everywhere to the sum of the learning
# rates.
BOUNDS = {"params": (TOL, 1e-4), "mu": (1e-4, 0.0), "nu": (1e-4, 0.0)}


def _share_off(got: dict, want: dict, bound: float) -> float:
    off = total = 0
    for k, w in want.items():
        g = np.asarray(got[k].detach(), np.float64)
        off += int((np.abs(g - w) > bound * np.abs(w).max()).sum())
        total += w.size
    return off / total


@pytest.mark.parametrize("micro", [1, 2])
def test_three_deepseek_steps_match_jax(micro):
    jc, pc, np_params, batch = _setup("deepseek-v2-236b", "pp")
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstep = jax.jit(jmake_train_step(jc, microbatches=micro, **STEP_KW))
    jopt = jadamw_init(jparams)
    model = from_jax_params(np_params, pc, device="cpu")
    pstep = make_train_step(pc, microbatches=micro, **STEP_KW)
    popt = adamw_init(dict(model.named_parameters()))
    lr_sum = 0.0
    for step in range(3):
        jbatch = {k: jnp.asarray(np.roll(v, step, axis=1))
                  for k, v in batch.items()}
        pbatch = {k: torch.from_numpy(np.roll(v, step, axis=1))
                  for k, v in batch.items()}
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        model, popt, pm = pstep(model, popt, pbatch)
        assert set(pm) == set(jm) == {"loss", "xent", "aux", "grad_norm",
                                      "lr"}
        for k in jm:
            if float(jm[k]) == 0.0:
                assert float(pm[k]) == 0.0, (step, k)
            else:
                assert _rel(pm[k], jm[k]) < (TOL if step == 0
                                             else 10 * TOL), (step, k)
        assert (float(pm["aux"]) == 0.0) == (micro > 1)
        lr_sum += float(jm["lr"])
    assert int(popt["count"]) == int(jopt["count"]) == 3
    trees = {"params": (model.state_dict(), _by_name(jparams, pc))}
    trees.update({t: (popt[t], _by_name(jopt[t], pc)) for t in ("mu", "nu")})
    for t, (got, want) in trees.items():
        assert set(got) == set(want), t
        bound, share = BOUNDS[t]
        assert _share_off(got, want, bound) <= share, t
    got, want = trees["params"]
    for k, w in want.items():
        assert float(np.abs(got[k].numpy() - w).max()) <= lr_sum, k


@pytest.mark.parametrize("arch,shape,what", [
    ("deepseek-v2-236b", {"data": 4, "model": 1}, "MLA"),
    ("mla-dense", {"data": 2, "model": 2}, "MLA"),
    ("recurrentgemma-9b", {"data": 2, "model": 2}, "RG-LRU"),
    ("rwkv6-1.6b", {"data": 2, "model": 2}, "RWKV"),
    ("whisper-tiny", {"data": 2, "model": 2}, "encoder-decoder"),
    ("paligemma-3b", {"data": 2, "model": 2}, "prefix-LM")])
def test_mesh_step_refuses_unsharded_stacks(arch, shape, what):
    """MLA (deepseek-v2 with its MoE layers, and the full-width MLA stack),
    RG-LRU (with MQA's one KV head, replicated beside the split query
    heads), RWKV, the encoder-decoder and the prefix-LM on more than one
    rank: no longer refused — the layout check of the train step and of
    both serving steps, which needs no process group, passes them."""
    from repro_torch.launch import steps as PS
    if arch == "mla-dense":
        from repro_torch.configs import deepseek_v2_236b as D
        cfg = D.mla_dense_config(n_layers=2)
    else:
        cfg = pconfigs.get_smoke(arch)
    make_train_step(cfg)                          # trains without a mesh
    for step in ("train", "serve"):
        PS._check_layout(cfg, ShardingRules(data_axes=("data",)),
                         shape["model"], step)


@pytest.mark.parametrize("shape", [(2, 2), (1, 1)], ids=["2x2", "1x1"])
def test_mesh_step_runs_moe_stacks(shape, tmp_path):
    """olmoe's MoE stack on a (data, model) mesh: no refusal, and the train
    step (one step at B 4 x S 16, its ``aux`` the router's loss, not 0),
    the prefill and a serve step run on gloo ranks (the 2 x 2 mesh spawns
    four, ``_torch_ranks``' ``moe`` job; the 1 x 1 one runs here) with
    finite results. ``tests/test_torch_sharded_moe.py`` holds them to the
    JAX reference."""
    import _torch_ranks as R
    from repro_torch.launch import steps as PS
    jc, pc = _cfgs("olmoe-1b-7b", "pp")
    for step in ("train", "serve"):
        PS._check_layout(pc, ShardingRules(data_axes=("data",)), shape[1],
                         step)
    params, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, pc.vocab, (B, S)).astype(np.int32)
    cases = {
        "serve": {"olmoe": dict(cfg=pc, mesh=shape, max_len=S + 2,
                                params=params, tokens=tokens,
                                stagger=np.zeros(B, np.int32), steps=1)},
        "train": {"olmoe": dict(cfg=pc, mesh=shape, params=params,
                                batch={"tokens": tokens,
                                       "targets": np.roll(tokens, -1, 1)},
                                steps=1, step_kw=STEP_KW | {
                                    "microbatches": 1})},
        "bytes": {}}
    if shape == (1, 1):
        import torch.distributed as dist
        dist.init_process_group("gloo", store=dist.FileStore(
            str(tmp_path / "store"), 1), rank=0, world_size=1)
        try:
            got = {part: fn(cases[part], {}, *extra) for part, fn, extra in (
                ("serve", R._serve_cases, (0, 1)),
                ("train", R._train_cases, ()))}
        finally:
            dist.destroy_process_group()
    else:
        R._save(tmp_path, "moe_in.pkl", cases)
        R.spawn(4, "moe", tmp_path)
        got = R.load(tmp_path, "moe_out.pkl")
    logits = got["serve"]["olmoe"]["logits"]
    assert len(logits) == 2 and all(np.isfinite(x).all() for x in logits)
    assert logits[0].shape == (B, pc.vocab)
    (m,) = got["train"]["olmoe"]["metrics"]
    assert all(np.isfinite(v) for v in m.values()), m
    assert m["aux"] > 0 and m["loss"] == pytest.approx(m["xent"] + m["aux"])
