"""The port's training path against the JAX reference on the CPU, qwen3
smoke (4 layers, d 64, 4/2 heads, vocab 256) in float32, without SOI and
with SOI pp and fp:

  * ``loss_fn``'s value and the gradient of every parameter against
    ``jax.value_and_grad(repro.models.transformer.loss_fn)`` on the same
    numpy weights (``from_jax_params`` carries the JAX grad tree across
    too), within 1e-5 of each leaf's largest |value|; with targets masked
    at -1;
  * three ``make_train_step`` steps against the jitted JAX step —
    microbatches 1 and 2, int8 compression off and on, each mode covering
    all four — params, moments, error state, ``count`` and the metrics
    (the bounds past the first step: see ``BOUNDS``);
  * the bf16 config keeps float32 masters and float32 grads (the cast
    runs inside the differentiated function);
  * the counterpart of the reference's two-steps-reduce-loss, RWKV and
    LayerNorm stacks through ``make_train_step`` and ``launch.train``, and
    ``launch.train.main`` on the CPU for 6 steps under the supervisor with
    a checkpoint directory.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.qwen3_1_7b as Q
from repro.distributed.sharding import split_axes
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as pconfigs
from repro_torch.checkpoint import latest_step
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.convert import from_jax_params
from repro_torch.launch import train as ptrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw_init

torch.set_num_threads(1)

TOL = 1e-5
B, S = 4, 16
STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=10)


def _cfgs(mode):
    return (dataclasses.replace(Q.smoke_config(soi=mode), dtype="float32"),
            dataclasses.replace(PQ.smoke_config(soi=mode), dtype="float32"))


def _random_params(cfg, seed=0):
    """The reference's tree (from an abstract init) with every leaf drawn
    by numpy: fan-in scaled weights, unit embeddings, nonzero norms."""
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


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("mode", [None, "pp", "fp"])
def test_loss_and_every_grad_match_jax(mode):
    jc, pc, np_params, batch = _setup(mode)
    jparams = jax.tree.map(jnp.asarray, np_params)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {k: jnp.asarray(v)
                                     for k, v in batch.items()}),
        has_aux=True)(jparams)
    model = from_jax_params(np_params, pc, device="cpu")
    loss, metrics = PT.loss_fn(model, pc, _port_batch(batch))
    loss.backward()
    assert _rel(loss, jl) < TOL
    assert _rel(metrics["xent"], jm["xent"]) < TOL
    assert float(metrics["aux"]) == 0.0
    want = _by_name(jg, pc)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) < TOL, k


# each mode covers microbatches 1 and 2 and compression off and on
STEP_CASES = [(None, 1, False), (None, 2, True), ("pp", 1, True),
              ("pp", 2, False), ("fp", 1, False), ("fp", 2, True)]
# Past the first step the two runs are chaotic in a few elements: AdamW
# divides each element's moment by its own root mean square, so an
# element whose gradient is ~1e-6 of its leaf's largest carries its
# float32 rounding (PyTorch's and XLA's sums differ in order) into an
# update of the learning rate's size; with int8 compression ~0.2% of the
# first step's gradients already round to the neighbouring level (a
# level is 1/127 of a 256-block's largest value, and a small block's
# level is a small multiple of the float32 noise of the leaf's largest
# gradient), and error feedback carries that on. So each tree is held
# element by element to (bound × its leaf's largest |value|) except for a
# share of its elements (measured at the parent of these bounds: params 2
# of 213696 without compression, 0.5% with; moments 0 / 1.3% at 1e-4; the
# error state 1% at 0.1), the params everywhere to the sum of the
# learning rates (what AdamW can move an element in three steps), and the
# metrics to 1e-5 at the first step (before anything is quantized) and
# 1e-4 after.
BOUNDS = {False: {"params": (TOL, 1e-4), "mu": (1e-4, 0.0),
                  "nu": (1e-4, 0.0)},
          True: {"params": (TOL, 2e-2), "mu": (1e-4, 2e-2),
                 "nu": (1e-4, 2e-2), "err": (0.1, 2e-2)}}


def _share_off(got: dict, want: dict, bound: float) -> float:
    """Share of the tree's elements off by more than ``bound`` of their
    leaf's largest |value|."""
    off = total = 0
    for k, w in want.items():
        g = np.asarray(got[k].detach() if torch.is_tensor(got[k])
                       else got[k], np.float64)
        off += int((np.abs(g - w) > bound * np.abs(w).max()).sum())
        total += w.size
    return off / total


@pytest.mark.parametrize("mode,micro,compress", STEP_CASES)
def test_three_train_steps_match_jax(mode, micro, compress):
    jc, pc, np_params, batch = _setup(mode)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstep = jax.jit(jmake_train_step(jc, microbatches=micro,
                                     compress=compress, **STEP_KW))
    jopt = jadamw_init(jparams)
    model = from_jax_params(np_params, pc, device="cpu")
    pstep = make_train_step(pc, microbatches=micro, compress=compress,
                            **STEP_KW)
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
            assert _rel(pm[k], jm[k]) < (TOL if step == 0 else 10 * TOL), \
                (step, k)
        lr_sum += float(jm["lr"])
    assert int(popt["count"]) == int(jopt["count"]) == 3
    assert popt["count"].dtype == torch.int32
    assert ("err" in popt) == compress
    trees = {"params": (model.state_dict(), _by_name(jparams, pc))}
    trees.update({t: (popt[t], _by_name(jopt[t], pc))
                  for t in BOUNDS[compress] if t != "params"})
    for t, (got, want) in trees.items():
        assert set(got) == set(want), t
        bound, share = BOUNDS[compress][t]
        assert _share_off(got, want, bound) <= share, t
    got, want = trees["params"]
    for k, w in want.items():
        assert float(np.abs(got[k].numpy() - w).max()) <= lr_sum, k


def test_bf16_config_keeps_float32_masters_and_grads():
    cfg = PQ.smoke_config(soi="pp")
    assert cfg.dtype == "bfloat16"
    model = PT.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    _, _, _, batch = _setup(None)
    loss, _ = PT.loss_fn(model, cfg, _port_batch(batch))
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name


def test_two_steps_reduce_loss_direction():
    """A few steps on a constant batch reduce the loss (the counterpart of
    tests/test_models_smoke.py's qwen3 case)."""
    cfg = pconfigs.get_smoke("qwen3-1.7b")
    model = PT.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    step = make_train_step(cfg, peak_lr=5e-3, warmup=1, total_steps=100)
    opt = adamw_init(dict(model.named_parameters()))
    losses = []
    for _ in range(5):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "nemotron-4-15b"])
def test_moe_and_rglru_training_refused(arch):
    """The kinds this test once held refused (RWKV blocks, LayerNorm with
    squared ReLU) train now, in make_train_step and launch.train, as MoE
    and RG-LRU stacks do (tests/test_torch_train_zoo.py and
    test_torch_train_families.py hold them against the JAX trainer)."""
    cfg = pconfigs.get_smoke(arch)
    make_train_step(cfg)
    losses = ptrain.main(["--device", "cpu", "--smoke", "--arch", arch,
                          "--steps", "1", "--batch", "2", "--seq", "16"])
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_train_main_on_the_cpu_with_checkpoints(tmp_path, capsys):
    d = str(tmp_path / "ck")
    losses = ptrain.main(["--device", "cpu", "--smoke", "--soi", "pp",
                          "--steps", "6", "--batch", "4", "--seq", "32",
                          "--ckpt-dir", d, "--ckpt-every", "3",
                          "--log-every", "2"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert latest_step(d) == 5
    assert sorted(x for x in os.listdir(d)) == ["step_00000002",
                                                "step_00000005"]
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "done: 6 steps" in out
