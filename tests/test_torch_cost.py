"""repro_torch.analysis.cost against repro.analysis.cost:

  * the port's ``measure_target`` gives the reference's ``flops`` /
    ``flops_min`` for every entry of gqa-dense and mla-dense, both run
    live on the CPU — one named term: mla-dense's prefill runs the flash
    kernel at dv != dqk, where the reference's own registry formula (which
    the port copies) and the dots its parser counts on the CPU differ;
  * the speculative windows against the reference's checked-in
    ``cost_baseline.json``, with their named term: each draft step's SOI
    compress projection, whose result no branch reads, which XLA drops as
    dead code under the draft's constant-false predicate and the port's
    eager step computes;
  * the full-width qwen3-1.7b generate step, counted under
    ``FakeTensorMode``, clears ``middle_trunk_floor`` (and the floor is the
    reference's closed form);
  * counterparts of ``test_cost.py``'s COST001–COST005 fault tests.
"""

import dataclasses
import json
import pathlib

import jax  # noqa: F401  (the reference's cost pass lowers with it)
import numpy as np  # noqa: F401
import pytest
import torch

from repro.analysis import cost as ref_cost
from repro.analysis import targets as ref_targets
from repro_torch.analysis import cost
from repro_torch.analysis import targets as targets
from repro_torch.kernels import costs as kernel_costs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _dots_flash(out, ops):
    """flash_attention charged the dots of the reference's CPU path:
    QK^T over dqk and PV over dv."""
    return {"flops": 2.0 * ops[1].dims[1] * (ops[0].elems + out.elems),
            "bytes": 0.0}


@pytest.fixture(scope="module")
def live_pairs():
    out = {}
    for name in ("gqa-dense", "mla-dense"):
        mine = cost.measure_target(targets.get_target(name, "cpu"))
        theirs = ref_cost.measure_target(ref_targets.get_target(name))
        out[name] = (mine, theirs)
    return out


@pytest.mark.parametrize("name", ["gqa-dense", "mla-dense"])
def test_measure_target_matches_reference(live_pairs, name, monkeypatch):
    mine, theirs = live_pairs[name]
    assert set(mine) == set(theirs)
    for entry, c in mine.items():
        assert c.contract == theirs[entry].contract, entry
        got = (c.flops, c.flops_min)
        want = (theirs[entry].flops, theirs[entry].flops_min)
        if name == "mla-dense" and entry == "prefill":
            # the named term: dv != dqk on MLA's prefill flash. Priced as
            # the reference's CPU path runs it, the count is exact
            assert got != want
            cost._COST_CACHE.clear()
            monkeypatch.setitem(kernel_costs.KERNEL_COSTS,
                                "flash_attention", _dots_flash)
            t = targets.get_target(name, "cpu")
            e = next(e for e in t.engine.analysis_entries(t.params)
                     if e.name == entry)
            c = cost.measure_entry(e)
            got = (c.flops, c.flops_min)
            cost._COST_CACHE.clear()
        assert got == want, (name, entry)


@pytest.mark.parametrize("name", ["gqa-dense-spec", "mla-dense-spec"])
def test_spec_window_against_reference_baseline(name):
    """The window's FLOPs are the reference's plus one dead SOI compress
    projection (2·B·stride·d·d) a draft step, K−1 drafts a window."""
    base = json.loads((ROOT / "cost_baseline.json").read_text())
    want = base["cells"][name]["speculative_window"]
    t = targets.get_target(name, "cpu")
    c = cost.measure_target(t)["speculative_window"]
    k, b = c.contract["k"], c.contract["batch"]
    d, st = t.cfg.d_model, t.cfg.soi.stride
    term = (k - 1) * 2.0 * b * st * d * d
    assert (c.flops, c.flops_min) == (want["flops"] + term,
                                      want["flops_min"] + term)


def test_middle_trunk_floor_is_the_reference_closed_form():
    import repro.configs.deepseek_v2_236b as RDS
    import repro.configs.qwen3_1_7b as RQ
    import repro_torch.configs.deepseek_v2_236b as DS
    import repro_torch.configs.qwen3_1_7b as Q
    for mine, theirs in ((Q.smoke_config(soi="pp"), RQ.smoke_config(soi="pp")),
                         (Q.config(soi="pp"), RQ.config(soi="pp")),
                         (DS.smoke_config(soi="pp"),
                          RDS.smoke_config(soi="pp"))):
        assert (cost.middle_trunk_floor(mine, 4)
                == ref_cost.middle_trunk_floor(theirs, 4) > 0)


def test_full_width_qwen3_clears_the_floor():
    """qwen3-1.7b at full width, B 4, max_len 1024, bf16, under
    FakeTensorMode (nothing allocated): phase-0 against off-phase FLOPs,
    and the gap clears the middle trunk's floor (COST001)."""
    import repro_torch.configs.qwen3_1_7b as Q
    cfg = Q.config(soi="pp")
    c = cost.measure_engine(cfg, dict(max_concurrent_decodes=4,
                                      max_len=1024), fake=True)["generate"]
    assert (c.flops, c.flops_min) == (14602469376.0, 8730443776.0)
    assert c.kernels == {"decode_attention": 28}
    floor = cost.middle_trunk_floor(cfg, 4)
    assert c.flops - c.flops_min >= floor > 5.6e9
    assert cost._certify_cell("qwen3-1.7b", {"generate": c}, cfg) == []
    # weights (bf16) dominate the bytes a step
    assert 3.4e9 < c.bytes < 4.4e9 and c.bytes_min < c.bytes


# ------------------------------------------------------- certifier fixtures

def _ec(flops, flops_min, nbytes, contract=None):
    return cost.EntryCost(flops=flops, flops_min=flops_min, bytes=nbytes,
                          bytes_min=nbytes, contract=contract)


def _gqa_soi_cfg():
    import repro_torch.configs.qwen3_1_7b as Q
    return dataclasses.replace(Q.smoke_config(soi="pp"), dtype="float32")


def test_cost001_lost_skip_flagged():
    cfg = _gqa_soi_cfg()
    floor = cost.middle_trunk_floor(cfg, 2)
    assert floor > 0
    ct = {"role": "generate", "stride": 2, "batch": 2}
    bad = {"generate": _ec(1e6, 1e6 - floor / 2, 1e6, contract=ct)}
    good = {"generate": _ec(1e6, 1e6 - floor * 1.5, 1e6, contract=ct)}
    assert {f.code for f in cost._certify_cell("x", bad, cfg)} == {"COST001"}
    assert cost._certify_cell("x", good, cfg) == []


def test_cost002_paged_byte_blowup_flagged():
    ct = {"role": "generate", "stride": 1, "batch": 2}
    cells = {
        "gqa-dense": {"generate": _ec(1e6, 1e6, 1e6, contract=ct)},
        "gqa-paged": {"generate": _ec(1e6, 1e6, 8e6, contract=ct)},
    }
    assert {f.code for f in cost._certify_cross(cells)} == {"COST002"}
    cells["gqa-paged"]["generate"] = _ec(1e6, 1e6, 1.1e6, contract=ct)
    assert cost._certify_cross(cells) == []


def test_cost003_spec_window_identity_flagged():
    g = {"role": "generate", "stride": 2, "batch": 2}
    w = {"role": "spec_window", "stride": 2, "k": 2, "batch": 2}
    cells = {
        "gqa-dense": {"generate": _ec(10.0, 6.0, 1e6, contract=g)},
        # bound = (2-1)*6 + 2*10 = 26; 40 is a re-computing window
        "gqa-dense-spec": {"speculative_window":
                           _ec(40.0, 20.0, 1e6, contract=w)},
    }
    assert {f.code for f in cost._certify_cross(cells)} == {"COST003"}
    cells["gqa-dense-spec"]["speculative_window"] = \
        _ec(26.0, 18.0, 1e6, contract=w)
    assert cost._certify_cross(cells) == []


def test_cost004_recomputing_hydrate_flagged():
    cfg = _gqa_soi_cfg()
    ct = {"role": "hydrate", "tokens": 16, "stride": 2}
    chunk = _ec(6e6, 6e6, 4e6,
                contract={"role": "prefill_chunk", "tokens": 16, "batch": 1,
                          "stride": 2})
    bad = {"hydrate": _ec(5e5, 5e5, 5e6, contract=ct),
           "prefill_chunk": chunk}
    codes = [f.code for f in cost._certify_cell("pc", bad, cfg)]
    assert codes.count("COST004") == 2
    good = {"hydrate": _ec(0.0, 0.0, 7e4, contract=ct),
            "prefill_chunk": chunk}
    assert cost._certify_cell("pc", good, cfg) == []


def test_cost005_baseline_drift_flagged(tmp_path):
    row = {"flops": 100.0, "flops_min": 50.0, "bytes": 100.0,
           "bytes_min": 50.0}
    base = {"tolerance": 0.10, "cells": {"gqa-dense": {"generate": row}}}
    ok = {"gqa-dense": {"generate": dict(row, flops=105.0)}}
    assert cost._certify_baseline(ok, base) == []
    grown = {"gqa-dense": {"generate": dict(row, flops=120.0)}}
    assert ({f.code for f in cost._certify_baseline(grown, base)}
            == {"COST005"})
    missing = {"gqa-dense": {"new_entry": row}}
    assert ({f.code for f in cost._certify_baseline(missing, base)}
            == {"COST005"})
    # the write / merge / diff round trip keeps other cells' rows
    path = str(tmp_path / "cost.json")
    cost.write_cost_baseline({"mla-dense": {"generate": row}}, path,
                             merge_with=base)
    back = cost.load_cost_baseline(path)
    assert set(back["cells"]) == {"gqa-dense", "mla-dense"}
    assert cost.diff_cost_baseline(grown, back) == [
        "  ~ gqa-dense.generate.flops: 100 -> 120 (+20.0%)"]


def test_checked_in_cost_baseline_is_current():
    """cost_baseline_torch.json holds this tree's metrics for the matrix
    cells (regenerate with ``--update-baseline`` after an audited
    change); the CPU run certifies clean against it."""
    findings, metrics = cost.run_matrix(list(targets.MATRIX), device="cpu")
    assert findings == [], [f.render() for f in findings]
    base = cost.load_cost_baseline(str(ROOT / "cost_baseline_torch.json"))
    assert {c: base["cells"][c] for c in metrics} == metrics
