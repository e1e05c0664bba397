"""Per-layer rematerialisation in the port's train path (``cfg.remat``,
``cfg.remat_policy``; ``repro_torch.models.remat``) on the CPU, at smoke
width, over six families: qwen3 (SOI pp), olmoe (MoE, its aux loss, pp),
recurrentgemma at 7 layers (a scanned (rec, rec, att) segment of two
groups and a trailing scanned ``(rec,)`` segment; pp: both groups in the
middle, the ``(rec,)`` after it), deepseek-v2 (MLA + MoE, its unscanned
first dense layer, pp), whisper-tiny (the encoder's segments) and rwkv6
(pp), with the weights of ``tests/test_torch_train_families.py`` (its
``GAIN``) and a B 3 x S 16 batch with stubs:

  * loss and every gradient of ``loss_fn`` bit for bit the run without
    remat under each policy — ``"full"``, ``"none"``, ``"dots"`` and
    ``"names"`` — in float32 and in bfloat16 over float32 masters (the
    recompute must run on the cast copies, not on the masters);
  * the port's float32 loss and gradients (remat on, the default)
    against ``jax.value_and_grad`` of the reference's ``loss_fn`` (its
    default ``remat=True``), within ``TOL`` of each leaf's largest, for
    the 7-layer recurrentgemma; the other five families are held so,
    with remat on in both, by ``tests/test_torch_train.py`` (qwen3 pp),
    ``tests/test_torch_train_families.py`` (olmoe pp, deepseek-v2 pp, at
    the same draw) and ``tests/test_torch_train_zoo.py`` (whisper-tiny,
    rwkv6 pp), and each jitted reference gradient costs ~6 s to trace and
    compile;
  * the checkpointed groups are the reference's scan bodies (a scanned
    segment's ``len(seg.blocks)`` layers), and each block runs twice a
    step in one (the forward and the backward's recompute), once without
    remat; deepseek-v2's unscanned first layer once either way;
  * what each policy saves, read from the ops the backward runs inside
    the scanned groups (a dispatch mode counting aten's ops, the
    recompute's early stop off): ``"full"`` and ``"none"`` run every op
    of the groups' forward again (they save nothing), ``"dots"`` all but
    the matmuls, ``"names"`` all but the tagged ffn hidden; without remat
    the blocks save tensors wider than d for the backward (pack hooks);
  * a run without grad (``forward``, the prefill) enters no checkpoint.

About 45 s on one worker.
"""

import collections
import dataclasses
import functools
import importlib
import math

import numpy as np
import pytest
import torch

from repro_torch.convert import from_jax_params
from repro_torch.launch.steps import make_prefill
from repro_torch.models import remat as R
from repro_torch.models import transformer as PT
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop
from test_torch_train_families import (TOL, _by_name, _cfgs, _random_params,
                                       _rel)

import jax
import jax.numpy as jnp
from repro.models import transformer as JT

torch.set_num_threads(1)

B, S = 3, 16
FAMILIES = ["qwen3 pp", "olmoe pp", "rg 7 pp", "ds pp", "whisper", "rwkv6 pp"]
POLICIES = ["full", "none", "dots", "names"]


def _rg7(pkg, mode):
    """recurrentgemma at smoke width, two (rec, rec, att) groups and one
    trailing RG-LRU layer."""
    mod = importlib.import_module(f"{pkg}.configs.recurrentgemma_9b")
    return dataclasses.replace(mod._cfg(2, 1, 64, 4, 16, 160, 256, 8, 4,
                                        mode), dtype="float32")


@functools.lru_cache(maxsize=None)
def _setup(family):
    """(reference config, port config, numpy weights, numpy batch)."""
    arch, mode = {"qwen3 pp": ("qwen3-1.7b", "pp"),
                  "olmoe pp": ("olmoe-1b-7b", "pp"),
                  "ds pp": ("deepseek-v2-236b", "pp"),
                  "whisper": ("whisper-tiny", None),
                  "rwkv6 pp": ("rwkv6-1.6b", "pp")}.get(family, (None, None))
    if family == "rg 7 pp":
        jc, pc = _rg7("repro", "pp"), _rg7("repro_torch", "pp")
    else:
        jc, pc = _cfgs(arch, mode)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    targets = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    targets[0, :3] = -1
    batch = {"tokens": tokens, "targets": targets}
    if jc.encoder is not None:
        batch["encoder_frames"] = rng.standard_normal(
            (B, jc.encoder.n_frames, jc.encoder.d_model)).astype(np.float32)
    return jc, pc, _random_params(jc), batch


def _as(model, cfg):
    """``model`` with ``cfg`` as its config: the same weights under
    another remat setting, which the trunk reads from the model's cfg
    (building the model again would draw and overwrite its weights)."""
    model.cfg = cfg
    return model


def _grads(model, cfg, batch):
    """(loss, metrics, {name: grad}) of the port's ``loss_fn`` on
    ``model`` (its cfg ``cfg``)."""
    named = dict(model.named_parameters())
    loss, metrics = PT.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), metrics, dict(zip(named, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_every_policy_is_the_run_without_remat_bit_for_bit(family, dtype):
    _, pc, params, batch = _setup(family)
    pc = dataclasses.replace(pc, dtype=dtype)
    model = from_jax_params(params, pc, device="cpu")

    def run(cfg):
        return _grads(_as(model, cfg), cfg, batch)
    want_loss, want_m, want = run(dataclasses.replace(pc, remat=False))
    assert torch.isfinite(want_loss)
    for policy in POLICIES:
        loss, m, got = run(dataclasses.replace(pc, remat_policy=policy))
        assert torch.equal(loss, want_loss), policy
        assert torch.equal(m["aux"], want_m["aux"]), policy
        for k, g in want.items():
            assert g.dtype == torch.float32, k
            assert torch.equal(got[k], g), (policy, k)


def _jax_grad(family):
    """The reference's loss, metrics and gradients, jitted."""
    jc, _, params, batch = _setup(family)
    fn = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, jc, b),
                                    has_aux=True))
    return jax.tree.map(np.asarray, fn(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}))


@pytest.mark.parametrize("family", ["rg 7 pp"])
def test_port_with_remat_matches_the_reference(family):
    jc, pc, params, batch = _setup(family)
    assert jc.remat and pc.remat and pc.remat_policy == "full"
    (jl, jm), jg = _jax_grad(family)
    loss, metrics, got = _grads(from_jax_params(params, pc, device="cpu"),
                                pc, batch)
    assert _rel(loss, jl) < TOL
    assert _rel(metrics["aux"], jm["aux"]) < TOL or float(jm["aux"]) == 0.0
    want = _by_name(jg, pc)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) < TOL, k


def _scanned(pc) -> dict:
    """{block name: whether its segment is scanned}, the encoder's too."""
    out = {}
    for prefix, segs in (("blocks", pc.segments),) + (
            (("encoder.blocks", pc.encoder.segments),)
            if pc.encoder is not None else ()):
        i = 0
        for seg in segs:
            for j in range(i, i + seg.n_layers):
                out[f"{prefix}.{j}"] = seg.scan
            i += seg.n_layers
    return out


def _watch(monkeypatch, model):
    """Count each block's runs, and record the shapes of the tensors that
    aren't a parameter's saved for the backward while a block runs."""
    names = {bp: n for n, bp in model.named_modules()
             if isinstance(bp, PT.Block)}
    shapes = {tuple(p.shape) for p in model.parameters()}
    runs, saved, inside = {}, [], []
    apply = PT._block_apply

    def counted(bp, *args, **kw):
        name = names[bp]
        runs[name] = runs.get(name, 0) + 1
        inside.append(1)
        try:
            return apply(bp, *args, **kw)
        finally:
            inside.pop()
    monkeypatch.setattr(PT, "_block_apply", counted)

    def pack(t):            # an activation: not of a parameter's shape
        if inside and tuple(t.shape) not in shapes:
            saved.append(tuple(t.shape))
        return t
    return runs, saved, pack


@pytest.mark.parametrize("family", FAMILIES)
def test_blocks_run_twice_in_rematerialised_groups(family, monkeypatch):
    _, pc, params, batch = _setup(family)
    model = from_jax_params(params, pc, device="cpu")
    runs, saved, pack = _watch(monkeypatch, model)
    scanned = _scanned(pc)
    groups = []
    remat_group = PT.remat_group

    def counted(fn, policy, x, *flat):
        groups.append(len(fn.args[0]))
        return remat_group(fn, policy, x, *flat)
    monkeypatch.setattr(PT, "remat_group", counted)
    # the reference's scan bodies: len(seg.blocks) layers of a scanned
    # segment (recurrentgemma's (rec, rec, att) twice, then its (rec,))
    want = [len(seg.blocks) for seg in pc.segments + (
        pc.encoder.segments if pc.encoder is not None else ())
        if seg.scan for _ in range(seg.n_groups)]
    for remat in (True, False):
        cfg = dataclasses.replace(pc, remat=remat)
        _as(model, cfg)
        runs.clear()
        saved.clear()
        groups.clear()
        named = dict(model.named_parameters())
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = PT.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        torch.autograd.grad(loss, list(named.values()))
        assert set(runs) == set(scanned)
        for name, n in runs.items():
            assert n == (2 if remat and scanned[name] else 1), (name, n)
        assert sorted(groups) == (sorted(want) if remat else [])
        if not remat:
            # the positive control of the next test's reading: the blocks'
            # activations, many carries' worth, saved for the backward
            assert sum(map(math.prod, saved)) > 4 * B * S * pc.d_model
    if family == "ds pp":
        assert not scanned["blocks.0"] and all(
            v for k, v in scanned.items() if k != "blocks.0")
    if family == "rg 7 pp":
        assert want == [3, 3, 1]


class _CountOps(TorchDispatchMode):
    """Counts aten's ops run while a layer group runs (``inside``), under
    ``phase``'s key; ``"tagged"`` stands for the copy ``checkpoint_name``
    makes. A checkpoint's selective policy answers a saved op from its
    cache above this mode: only ops that really run are counted. The
    detaches the recompute adds to what it saves are not the group's."""

    def __init__(self, inside: list):
        super().__init__()
        self.inside = inside
        self.phase = "forward"
        self.counts = {"forward": collections.Counter(),
                       "backward": collections.Counter()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.inside and func is not torch.ops.aten.detach.default:
            key = "tagged" if R._NAMING is not None else func
            self.counts[self.phase][key] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", FAMILIES)
def test_each_policy_recomputes_what_it_does_not_save(family, monkeypatch):
    _, pc, params, batch = _setup(family)
    inside = []
    remat_group = PT.remat_group

    def grouped(fn, policy, *args):
        def run(*a):
            inside.append(1)
            try:
                return fn(*a)
            finally:
                inside.pop()
        return remat_group(run, policy, *args)
    monkeypatch.setattr(PT, "remat_group", grouped)
    tagged = any(bp.mlp is not None for seg in pc.segments if seg.scan
                 for bp in seg.blocks)
    model = from_jax_params(params, pc, device="cpu")
    named = dict(model.named_parameters())
    for policy in POLICIES:
        cfg = dataclasses.replace(pc, remat_policy=policy)
        _as(model, cfg)
        count = _CountOps(inside)
        with count:
            # the recompute runs the whole group, not up to the last
            # tensor the backward reads
            with set_checkpoint_early_stop(False):
                loss, _ = PT.loss_fn(model, cfg, {
                    k: torch.from_numpy(v) for k, v in batch.items()})
            count.phase = "backward"
            torch.autograd.grad(loss, list(named.values()))
        fwd, bwd = count.counts["forward"], count.counts["backward"]
        assert sum(fwd[op] for op in R.DOTS) > 0, (policy, fwd)
        # the hidden is copied only where "names" saves it
        assert (fwd["tagged"] > 0) == (policy == "names" and tagged), fwd
        if policy == "dots":        # every op again but the matmuls
            want = {k: v for k, v in fwd.items() if k not in R.DOTS}
        elif policy == "names":     # every op again but the tagged copy
            want = {k: v for k, v in fwd.items() if k != "tagged"}
        else:                       # "full", "none": every op again
            want = fwd
        assert bwd == collections.Counter(want), (policy, bwd, want)


def test_runs_without_grad_enter_no_checkpoint(monkeypatch):
    _, pc, params, batch = _setup("qwen3 pp")
    model = from_jax_params(params, pc, device="cpu")
    calls = []
    remat_group = PT.remat_group

    def counted(*args):
        calls.append(1)
        return remat_group(*args)
    monkeypatch.setattr(PT, "remat_group", counted)
    tokens = torch.from_numpy(batch["tokens"])
    PT.forward(model, pc, tokens)
    make_prefill(pc, max_len=32)(model, {"tokens": tokens})
    with torch.no_grad():
        PT.loss_fn(model, pc, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert calls == []
    _grads(model, pc, batch)
    # qwen3 smoke pp: one layer a group, every layer scanned
    assert len(calls) == pc.n_layers


def test_a_step_whose_remat_is_not_its_models_is_refused():
    _, pc, params, batch = _setup("qwen3 pp")
    model = from_jax_params(params, pc, device="cpu")
    for kw in (dict(remat=False), dict(remat_policy="dots")):
        with pytest.raises(ValueError, match="remat"):
            PT.loss_fn(model, dataclasses.replace(pc, **kw),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
