"""The port's sharding layer against the reference's, without a process
group (``spec_for`` reads a mesh's axis names and sizes only):

  * the reference's three ``spec_for`` cases (``tests/test_sharding.py``)
    through both packages' ``spec_for``;
  * ``param_axes`` of the port's model equal to the reference's
    ``split_axes`` axes leaf for leaf (the scanned segments' leading
    ``"layers"`` axis dropped: the port holds one module a layer), for the
    smoke config of every LM arch;
  * every parameter's spec, the divisibility notes, and the bytes a device
    holds of the float32 params and of the AdamW state, for all 10 LM
    archs at full size on both production meshes under each arch's
    ``KNOBS``, equal to ``repro.distributed.sharding.make_specs`` over
    ``repro.launch.specs.abstract_params`` with a fake mesh;
  * the bytes a device holds of decode_32k's decode state, by leaf name,
    equal to the reference's ``decode_state_specs`` over
    ``abstract_decode_state``.
"""

import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.distributed import sharding as JS
from repro.launch import specs as JSP
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.convert import reference_names
from repro_torch.distributed import sharding as PS
from repro_torch.launch import specs as PSP
from repro_torch.launch.dryrun import KNOBS
from repro_torch.launch.mesh import AbstractMesh, production_shape

torch.set_num_threads(1)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.empty = False


SPEC_CASES = [
    (dict(data_axes=("data",)), {"data": 16, "model": 16},
     ("embed", "heads", "head_dim"), (2048, 16, 128)),
    (dict(data_axes=("data",)), {"data": 16, "model": 16},
     ("embed", "kv_heads", "head_dim"), (2048, 8, 128)),
    (dict(data_axes=("pod", "data"), fsdp=True),
     {"pod": 2, "data": 16, "model": 16}, ("embed", "ff"), (4096, 16384)),
    (dict(data_axes=("data",), seq_shard=True), {"data": 16, "model": 16},
     ("batch", "seq_act", "heads"), (256, 4096, 16)),
]


@pytest.mark.parametrize("rules,mesh,axes,shape", SPEC_CASES)
def test_spec_for_matches_the_reference(rules, mesh, axes, shape):
    jn, pn = [], []
    want = JS.spec_for(axes, shape, JS.ShardingRules(**rules),
                       _FakeMesh(mesh), jn)
    got = PS.spec_for(axes, shape, PS.ShardingRules(**rules),
                      AbstractMesh(mesh), pn)
    assert got == tuple(want)
    assert pn == jn


def test_shapes_table_is_the_reference_s():
    from repro.configs.base import SHAPES as JSHAPES
    from repro_torch.configs.base import SHAPES
    assert SHAPES == JSHAPES


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "paligemma-3b",
                                  "whisper-tiny"])
def test_batch_specs_match_the_reference(arch, shape, multi):
    """Shapes, dtypes and row layout of a train / prefill batch, with the
    stub frontends' inputs (paligemma's patches, whisper's frames)."""
    names = production_shape(multi)
    data = tuple(a for a in names if a != "model")
    jshapes, jsh = JSP.batch_specs(
        jconfigs.get(arch), shape, JS.ShardingRules(data_axes=data),
        jax.sharding.AbstractMesh(tuple(names.values()), tuple(names)))
    shapes, specs = PSP.batch_specs(configs.get(arch), shape,
                                    PS.ShardingRules(data_axes=data),
                                    AbstractMesh(names))
    assert set(shapes) == set(jshapes)
    for k, t in shapes.items():
        assert tuple(t.shape) == tuple(jshapes[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(jshapes[k].dtype), k
        assert specs[k] == tuple(_bare(e) for e in jsh[k].spec), k


def _bare(entry):
    """A singleton tuple entry as its axis name (the port's spelling)."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _drop_layers(leaf, g):
    return leaf[1:]


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_axes_match_the_reference(arch):
    jcfg, pcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    _, jaxes = JS.split_axes(jax.eval_shape(
        lambda k: JT.init(k, jcfg), jax.random.PRNGKey(0)))
    want = reference_names(jaxes, pcfg, index=_drop_layers)
    shapes, got = PSP.abstract_params(pcfg)
    assert got == want
    assert set(shapes) == set(got)
    for k, t in shapes.items():
        assert len(got[k]) == t.dim(), k


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return JSP.abstract_params(jconfigs.get(arch))


def _ref_layout(arch, multi):
    """The reference's (specs by port name, notes, param bytes a device) on
    a production fake mesh under the arch's knobs."""
    mesh = _FakeMesh(production_shape(multi))
    knobs = KNOBS[arch]
    rules = JS.ShardingRules(
        data_axes=tuple(a for a in mesh.axis_names if a != "model"),
        fsdp=knobs.get("fsdp", False), seq_shard=knobs.get("seq_shard", False))
    shapes, axes = _ref_abstract(arch)
    notes = []
    specs = JS.make_specs(axes, shapes, rules, mesh, notes)
    nbytes = 0
    for s, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        split = 1
        for e in spec:
            if e is not None:
                split *= math.prod(mesh.shape[a] for a in
                                   (e if isinstance(e, tuple) else (e,)))
        nbytes += math.prod(s.shape) * s.dtype.itemsize // split
    by_name = reference_names(
        specs, configs.get(arch), index=_drop_layers)
    return ({k: tuple(v) for k, v in by_name.items()}, sorted(set(notes)),
            nbytes, rules)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_full_size_specs_notes_and_bytes_match_the_reference(arch, multi):
    want_specs, want_notes, want_bytes, jrules = _ref_layout(arch, multi)
    mesh = AbstractMesh(production_shape(multi))
    rules = PS.ShardingRules(**dataclasses.asdict(jrules))
    notes = []
    shapes, specs = PSP.param_specs(configs.get(arch), rules, mesh, notes)
    assert specs == want_specs
    assert sorted(set(notes)) == want_notes
    got = PS.per_device_bytes(shapes, specs, mesh)
    assert got == want_bytes
    # AdamW: two float32 moments laid out like the params, count replicated
    opt = PS.per_device_bytes(PSP.abstract_opt(shapes),
                              PSP.opt_specs(specs), mesh)
    assert opt == 2 * want_bytes + 4


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return JSP.abstract_decode_state(jconfigs.get(arch), "decode_32k",
                                     _ref_abstract(arch)[0])[0]


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    return PSP.abstract_decode_state(configs.get(arch), "decode_32k")


def _ref_state_bytes(arch, multi):
    """{leaf name: bytes a device holds} of the reference's decode_32k
    state (``_CACHE_AXES``'s leaf names; the cross-attention K/V apart)."""
    mesh = _FakeMesh(production_shape(multi))
    rules = JS.ShardingRules(
        data_axes=tuple(a for a in mesh.axis_names if a != "model"))
    state = _ref_state(arch)
    specs = JSP.decode_state_specs(state, rules, mesh)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(state),
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        key = JSP._leaf_key(path)
        if any(getattr(e, "key", None) == "cross_kv" for e in path):
            key = "cross_" + key
        split = 1
        for e in spec:
            if e is not None:
                split *= math.prod(mesh.shape[a] for a in
                                   (e if isinstance(e, tuple) else (e,)))
        out[key] = out.get(key, 0) + (math.prod(leaf.shape) // split
                                      * leaf.dtype.itemsize)
    return out, rules


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_decode_state_bytes_match_the_reference(arch, multi):
    """The decode state a device holds, leaf name by leaf name. Two leaves
    are the port's own (the cross read's positions and query clocks,
    replicated); the encoder K/V of whisper are bf16 in the port and
    float32 in the reference's abstract state (its f32 masters promote the
    einsum), so they are held by elements."""
    want, jrules = _ref_state_bytes(arch, multi)
    mesh = AbstractMesh(production_shape(multi))
    rules = PS.ShardingRules(**dataclasses.asdict(jrules))
    state, (b, s) = _port_state(arch)
    assert (b, s) == (128, 32768)
    specs = PSP.decode_state_specs(state, rules, mesh)
    got = {}
    for label, leaf in state.items():
        key = PSP._leaf_key(label)
        if key in ("cross_pos", "cross_q_pos"):
            assert specs[label] == (None,) * leaf.dim()
            continue
        if label.startswith("cross_kv."):
            key = "cross_" + key
        n = leaf.numel() // PS.shard_factor(specs[label], mesh)
        got[key] = got.get(key, 0) + n * leaf.element_size()
    for key in ("cross_k", "cross_v"):
        if key in want:
            assert got[key] * 2 == want[key], key
            got[key] = want[key]
    assert got == want
