"""repro_torch.launch.plan and repro_torch.launch.bench against the
reference's (counterpart of ``tests/test_launch_plan.py``):

  * ``state_bytes_per_slot`` (FakeTensorMode over a throwaway engine)
    equals the reference's ``eval_shape`` count for every matrix cell —
    no leaf of the port's decode-state cache groups is missing from the
    reference's or extra;
  * ``plan_cell`` at ``TPU_V5E`` on the same metrics dict gives the
    reference's ``CellPlan`` field for field;
  * ``H100`` is the datasheet's card and ``chip_smoke.py`` takes its
    roofline figures from it;
  * ``validate_bench`` returns the reference's errors on the good and bad
    dicts of ``test_launch_plan.py``; ``write_bench`` refuses malformed
    rows; the honesty checks run on in-memory bench dicts.
"""

import dataclasses
import json
import math
import pathlib

import jax
import numpy as np  # noqa: F401
import pytest
import torch

from repro.analysis.targets import MATRIX as REF_MATRIX
from repro.launch import bench as ref_bench
from repro.launch import plan as ref_plan
from repro_torch.analysis.targets import MATRIX
from repro_torch.launch import bench, plan

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


GROUPS = ("segments", "pre", "mid", "post")


def _by_group_leaf(pairs) -> dict:
    """{(group, leaf name): bytes} summed over layers: the reference
    stacks a segment's layers into one leaf, the port keeps one a
    layer."""
    out = {}
    for label, b in pairs:
        keys = [k.strip("'") for k in label.strip("[]").split("][")]
        if "model" in keys:
            keys = keys[keys.index("model") + 1:]
        if keys[0] in GROUPS:
            key = (keys[0], keys[-1])
            out[key] = out.get(key, 0) + b
    return out


def _ref_leaves(name):
    from jax.tree_util import keystr, tree_flatten_with_path

    from repro.engine import SOIEngine
    from repro.launch.specs import abstract_params
    cfg_fn, kw = REF_MATRIX[name]
    engine = SOIEngine(cfg_fn(), **kw)
    shapes, _ = abstract_params(cfg_fn())
    ds = jax.eval_shape(engine.init_decode_state, shapes)
    return [(keystr(k), math.prod(x.shape) * x.dtype.itemsize)
            for k, x in tree_flatten_with_path(ds)[0]]


@pytest.mark.parametrize("name", list(MATRIX))
def test_state_bytes_per_slot_matches_reference(name):
    cfg_fn, kw = MATRIX[name]
    ref_fn, ref_kw = REF_MATRIX[name]
    assert kw == ref_kw
    mine = plan.state_bytes_per_slot(cfg_fn(), kw)
    assert mine == ref_plan.state_bytes_per_slot(ref_fn(), ref_kw)
    # leaf for leaf, each cache leaf (k, v, pos) of each group summed over
    # its layers: no leaf is extra or missing on either side
    ours = _by_group_leaf(plan.decode_state_leaves(cfg_fn(), kw))
    assert ours == _by_group_leaf(_ref_leaves(name)) != {}


REF_BASE = json.loads((ROOT / "cost_baseline.json").read_text())


@pytest.mark.parametrize("name", ["gqa-dense", "gqa-dense-spec",
                                  "mla-paged", "gqa-paged-pc"])
def test_plan_cell_matches_reference(name):
    """The same metrics dict (the reference's checked-in rows; the port
    reads no ``peak_bytes``) gives the reference's plan, field for field,
    on the reference's spec."""
    metrics = REF_BASE["cells"][name]
    mine = plan.plan_cell(name, plan.TPU_V5E, metrics)
    theirs = ref_plan.plan_cell(name, ref_plan.TPU_V5E, metrics)
    assert mine.to_dict() == theirs.to_dict()


def test_plan_on_h100_from_port_baseline():
    """The default spec is the H100; the port's own baseline plans: phases
    ordered, capacity positive, one program per entry; a full-width cell
    plans from its cfg and engine kwargs."""
    base = json.loads((ROOT / "cost_baseline_torch.json").read_text())
    p = plan.plan_cell("gqa-dense", metrics=base["cells"]["gqa-dense"])
    assert p.hardware == plan.H100.name
    assert p.step_s_offphase < p.step_s_phase0
    assert p.step_s_offphase <= p.step_s_avg <= p.step_s_phase0
    assert p.compile_count == len(base["cells"]["gqa-dense"])
    import repro_torch.configs.qwen3_1_7b as Q
    kw = dict(max_concurrent_decodes=4, max_len=1088)
    full = plan.plan_cell("qwen3-1.7b", metrics={"generate": {
        "flops": 1.4e10, "flops_min": 8.7e9, "bytes": 4e9,
        "bytes_min": 2.4e9}}, cfg=Q.config(soi="pp"), engine_kwargs=kw)
    assert full.step_s_phase0 == pytest.approx(4e9 / 3.35e12)
    assert 3.4e9 < full.param_bytes < 3.6e9          # bf16 weights
    # k, v, pos of 14 full-rate and 14 compressed layers a slot
    assert full.state_bytes_per_slot == 106534400
    assert 0 < full.max_slots < 1000


def test_hardware_spec_single_source_of_truth():
    """chip_smoke.py's roofline figures are plan.H100's; H100 is the SXM
    datasheet's card; TPU_V5E is the reference's."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    h = plan.H100
    assert chip_smoke.HBM_BYTES_PER_S == h.hbm_bw == 3.35e12
    assert chip_smoke.PEAK_FLOPS[torch.bfloat16] == h.peak_flops == 989.4e12
    assert chip_smoke.PEAK_FLOPS[torch.float32] == h.peak_flops_f32 == 67e12
    assert h.hbm_bytes == 80 * 2 ** 30 and h.link_bw == 50e9
    assert (dataclasses.asdict(plan.TPU_V5E)
            == dict(dataclasses.asdict(ref_plan.TPU_V5E),
                    peak_flops_f32=None))


def test_custom_hardware_spec_scales_plan():
    metrics = REF_BASE["cells"]["gqa-dense"]
    slow = dataclasses.replace(plan.H100, hbm_bw=plan.H100.hbm_bw / 2)
    big = dataclasses.replace(plan.H100, hbm_bytes=2 * plan.H100.hbm_bytes)
    p0 = plan.plan_cell("gqa-dense", plan.H100, metrics)
    assert plan.plan_cell("gqa-dense", slow, metrics).tok_s <= p0.tok_s
    assert plan.plan_cell("gqa-dense", big, metrics).max_slots >= p0.max_slots


def test_honesty_checks_on_dicts():
    """run_honesty_checks takes parsed bench dicts (no file is read): the
    steady-state composition, the bytes/slot geometry and the capture
    count, as the reference computes them."""
    soi = {"stride": 2, "batch": 4, "devloop_step_soi_phase0_s": 3e-3,
           "devloop_step_soi_offphase_s": 1e-3,
           "devloop_step_soi_aligned_s": 2e-3}
    geom = {"slots": 16, "resident_batch": 4, "max_len": 64,
            "page_size": 8}
    cfg_fn, _ = MATRIX["gqa-dense"]
    dense = plan.state_bytes_per_slot(cfg_fn(), dict(
        max_concurrent_decodes=16, max_len=64))
    paged_in = dict(geom, dense_bytes_per_slot=dense,
                    paged_bytes_per_slot=dense / 2)
    spec = {"stride2_k2": {"accept_rate": 1.0, "spec_compiles": 1}}
    mine = plan.run_honesty_checks(soi=soi, paged=paged_in, selfspec=spec)
    theirs = ([ref_plan.check_soi_bench(soi)]
              + ref_plan.check_paged_bench(paged_in)
              + ref_plan.check_selfspec_bench(spec))
    assert mine == theirs
    assert mine[1]["rel_err"] == 0.0 and mine[2]["rel_err"] < 0
    assert plan.run_honesty_checks() == []


GOOD = [{"tok_s": 12.5, "steps": 3, "bit_exact": True, "note": "cpu"},
        {"stride2_k2": {"accept_rate": 1.0, "spec_compiles": 1}}]
BAD = [[1, 2, 3], {}, {"x": float("nan")}, {"x": float("inf")},
       {"x": [1, 2]}, {"sweep": {"deep": {"deeper": 1}}}, {"sweep": {}},
       {"": 1}, {"sweep": {"": 1}}]


@pytest.mark.parametrize("data", GOOD + BAD)
def test_validate_bench_matches_reference(data):
    assert (bench.validate_bench(data, name="fixture")
            == ref_bench.validate_bench(data, name="fixture"))
    assert (bench.validate_bench(data, "BENCH_soi_lm.json")
            == ref_bench.validate_bench(data, "BENCH_soi_lm.json"))
    assert (bench.validate_bench(data, name="fixture") == []) == (
        data in GOOD)


def test_write_bench_refuses_malformed(tmp_path):
    path = tmp_path / "BENCH_torch_bad.json"
    with pytest.raises(ValueError):
        bench.write_bench({"x": float("nan")}, path)
    assert not path.exists()
    bench.write_bench({"x": 1.0}, path)
    assert json.loads(path.read_text()) == {"x": 1.0}
    assert bench.validate_bench_file(path) == []
    assert bench.repo_bench_files(tmp_path) == [path]
    assert bench.REQUIRED_KEYS == ref_bench.REQUIRED_KEYS
