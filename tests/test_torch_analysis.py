"""repro_torch.analysis: the port's hot-path contract checker catches known
violations and passes the real engine (counterpart of
``tests/test_analysis.py``).

Two halves:
  * seeded-violation fixtures — an undeclared big buffer, a big state leaf
    the step rebinds, a hidden per-step ``.item()`` (and the torch
    spellings of a host read), a same-iteration drain, a scalar in a
    non-static position, carry drift, a bf16 narrowing step, f64 — each
    must be FLAGGED with the reference's code; a deferred drain and the
    pragma must not be;
  * the shipped engine configurations (the ten matrix cells, the
    telemetry cell among them) produce ZERO findings on the CPU, and the
    port's host code scans clean.
"""

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro_torch.analysis import (donation, dtype_drift, hostsync, retrace,
                                  runtime)
from repro_torch.analysis import targets as T
from repro_torch.analysis.report import (Finding, Report, compare_to_baseline,
                                         load_baseline)
from repro_torch.engine import contracts
from repro_torch.engine.contracts import (CheckedGraph, GraphEntry,
                                          host_get, sanctioned_drain)

torch.set_num_threads(1)


def _codes(findings):
    return {f.code for f in findings}


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"big": torch.from_numpy(rng.standard_normal((64, 128))
                                    .astype(np.float32)),
            "t": torch.zeros(4, dtype=torch.int32)}


# ---------------------------------------------------------------- fixtures

def test_undeclared_big_buffer_flagged():
    """A large buffer that is neither state nor readonly_ok is DON001; a
    graph that does not list the entry's state argument is DON001."""
    big = torch.zeros(256, 256)

    def step(state, x):
        state["big"].add_(x)
        return state, x.sum()

    entry = GraphEntry("leaky_step", step, (_state(), big),
                       state_args=(0,), carry=(0, 0))
    assert "DON001" in _codes(donation.check_entry("fixture", entry))
    graph = CheckedGraph(step, state_argnums=())
    entry = GraphEntry("unlisted_step", step, (_state(), torch.ones(1)),
                       graph=graph, state_args=(0,), carry=(0, 0))
    assert "DON001" in _codes(donation.check_entry("fixture", entry))


def test_rebound_big_state_leaf_flagged():
    """A step that rebinds a big state leaf (a copy, not an in-place
    write) breaks the contract a captured graph rests on: DON002 from the
    analysis, DroppedDonationError from the executing CheckedGraph."""
    def step(state):
        state["big"] = state["big"] * 2.0
        return state

    entry = GraphEntry("copy_step", step, (_state(),), state_args=(0,),
                       carry=(0, None))
    assert "DON002" in _codes(donation.check_entry("fixture", entry))
    with pytest.raises(contracts.DroppedDonationError):
        CheckedGraph(lambda s: (step(s),), state_argnums=(0,))(_state())


def test_in_place_step_not_flagged():
    def step(state):
        state["big"].mul_(2.0)
        state["t"] = state["t"] + 1           # small: copied back
        return state

    entry = GraphEntry("clean_step", step, (_state(),), state_args=(0,),
                       carry=(0, None))
    assert donation.check_entry("fixture", entry) == []


@pytest.mark.parametrize("read", ["res.data.item()", "res.data.tolist()",
                                  "res.data.cpu()", "res.data.numpy()",
                                  "float(res.data)", "np.asarray(res.data)"])
def test_hidden_host_read_in_step_loop_flagged(read):
    src = f"""
import numpy as np

def serve(engine, params, state, n):
    outs = []
    for _ in range(n):
        state, res = engine.generate(params, state)
        outs.append({read})
    return outs
"""
    assert "SYNC001" in _codes(hostsync.scan_source(src, "fixture.py"))


def test_same_iteration_drain_flagged():
    src = """
def serve(engine, params, state, n):
    for _ in range(n):
        state, res = engine.generate(params, state)
        res = res.convert_to_numpy()
    return state
"""
    assert "SYNC003" in _codes(hostsync.scan_source(src, "fixture.py"))


def test_deferred_drain_and_pragma_not_flagged():
    src = """
import numpy as np

def serve(engine, params, state, n):
    pending = None
    for _ in range(n):
        state, res = engine.generate(params, state)
        if pending is not None:
            host = pending.convert_to_numpy()
            tok = int(host.get_result_at_slot(0).tokens[0])
        debug = res.logits.cpu()  # sync-ok: debugging fixture
        pending = res
    return state
"""
    assert hostsync.scan_source(src, "fixture.py") == []


def test_graph_bound_loop_detected():
    """Loops over a local name bound to a CheckedGraph count as step
    loops."""
    src = """
def bench(params, state, tok, n):
    step = CheckedGraph(lambda p, s, t: (s, t), state_argnums=(1,))
    for _ in range(n):
        state, out = step(params, state, tok)
        tok = out.item()
    return tok
"""
    assert "SYNC001" in _codes(hostsync.scan_source(src, "fixture.py"))


def test_runtime_tripwire_records_unsanctioned_item():
    """On the CPU the dispatch-mode tripwire records a host read outside a
    sanctioned drain, with its source line, and not one inside."""
    x = torch.arange(4.0)
    records = []
    with runtime.sync_monitor(records, "cpu"):
        x.sum().item()
        with sanctioned_drain():
            x.max().item()
    assert len(records) == 1 and "test_torch_analysis.py" in records[0]


def test_scalar_arg_retrace_flagged():
    """A Python int in a non-static position is RET002 statically; and a
    graph bakes such a value in — on the CPU the graph's key ignores it,
    which is the stale replay RET002 predicts."""
    def step(state, off):
        state["big"].add_(off)
        return (state,)

    entry = GraphEntry("offset_step", step, (_state(), 3), state_args=(0,),
                       carry=(0, 0))
    assert "RET002" in _codes(retrace._static_scan("fixture", entry))
    static = GraphEntry("offset_step", step, (_state(), 3), state_args=(0,),
                        static_args=(1,), carry=(0, 0))
    assert retrace._static_scan("fixture", static) == []
    graph = CheckedGraph(step, state_argnums=(0,))
    graph(_state(), 1), graph(_state(), 2)
    assert len(graph.keys()) == 1


def test_carry_dtype_drift_flagged():
    def step(state):
        state["big"] = state["big"].to(torch.bfloat16)
        return state

    entry = GraphEntry("drift_step", step, (_state(),), state_args=(0,),
                       carry=(0, None))
    assert "DT001" in _codes(dtype_drift.check_entry("fixture", entry, 4))


def test_bf16_narrowing_flagged():
    def step(state):
        x = state["big"].to(torch.bfloat16) @ torch.eye(
            128, dtype=torch.bfloat16)
        state["big"].copy_(x)
        return state

    entry = GraphEntry("narrow_step", step, (_state(),), state_args=(0,),
                       carry=(0, None))
    assert "DT002" in _codes(dtype_drift.check_entry("fixture", entry, 4))
    # the same conversion inside a bf16 config is its compute dtype
    assert "DT002" not in _codes(dtype_drift.check_entry("fixture", entry,
                                                         2))


def test_f64_flagged():
    def step(state):
        state["big"].add_(torch.ones(1, dtype=torch.float64).float())
        return state

    entry = GraphEntry("f64_step", step, (_state(),), state_args=(0,),
                       carry=(0, None))
    assert "DT003" in _codes(dtype_drift.check_entry("fixture", entry, 4))


def test_sanctioned_drain_nests_and_restores():
    assert not contracts.in_sanctioned_drain()
    with sanctioned_drain():
        assert contracts.in_sanctioned_drain()
        with sanctioned_drain():
            assert contracts.in_sanctioned_drain()
        assert contracts.in_sanctioned_drain()
    assert not contracts.in_sanctioned_drain()
    out = host_get(torch.arange(3))
    assert isinstance(out, np.ndarray)


def test_baseline_protocol(tmp_path):
    report = Report(findings=[
        Finding("donation", "DON001", "t:gen", "msg"),
        Finding("retrace", "RET001", "t:ins", "msg")])
    base = tmp_path / "base.json"
    diff = compare_to_baseline(report, str(base))
    assert not diff.clean and len(diff.new) == 2
    report_accept = Report(findings=[
        report.findings[0],
        Finding("dtype", "DT001", "gone:entry", "msg")])
    report_accept.write(str(base))
    assert len(load_baseline(str(base))) == 2
    diff = compare_to_baseline(report, str(base))
    assert [f.code for f in diff.new] == ["RET001"]
    assert [f.code for f in diff.accepted] == ["DON001"]
    assert diff.stale == [("dtype", "DT001", "gone:entry")]


def test_cli_defaults_to_the_card():
    """Without ``--device`` the CLI raises on a machine without a card
    (it never falls back to the CPU)."""
    from repro_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--targets", "gqa-dense", "-q"])


def test_card_default_targets_leave_out_mla():
    """On the card (``None`` means the card) the default cells are the GQA
    ones; the CPU runs the whole matrix."""
    for dev in (None, "cuda", torch.device("cuda")):
        names = T.default_targets(dev)
        assert names == list(T.CARD_TARGETS)
        assert not [n for n in names if n.startswith("mla")]
    assert T.default_targets("cpu") == list(T.MATRIX)
    assert len(T.MATRIX) == 10 and len(T.CARD_TARGETS) == 6


@pytest.mark.parametrize("name", [n for n in T.MATRIX
                                  if n.startswith("mla")])
def test_mla_cell_refused_on_card_up_front(name):
    """An MLA cell on the card is refused before anything is built, with a
    message naming the missing instantiations; on the CPU it is taken."""
    with pytest.raises(NotImplementedError,
                       match=r"no kernel instantiation.*\(24, 16\).*"
                             r"\(24, 8\)"):
        T.build_target(name, "cuda")
    with pytest.raises(NotImplementedError, match=name):
        T.check_device(name, None)
    T.check_device(name, "cpu")


# ------------------------------------------------------- the real contract

@pytest.mark.parametrize("name", T.default_targets("cpu"))
def test_hotpath_contracts(name):
    """The shipped engine configurations carry zero contract findings on
    the CPU: state written in place, no per-step host read, O(1) graphs
    under repeat traffic, a dtype-stable carry, the COST certifications
    (in-cell and against the checked-in baseline). gqa-paged-tele is the
    counterpart of ``test_obs.py::test_telemetry_target_passes_analysis``."""
    from repro_torch.analysis import analyze
    report = analyze([name], device="cpu")
    assert report.findings == [], report.render()


def test_matrix_cross_cell_certifications():
    """COST002 and COST003 compare sibling cells: clean over the matrix."""
    from repro_torch.analysis import cost
    findings, _ = cost.run_matrix(T.default_targets("cpu"), device="cpu",
                                  baseline_path=False)
    assert findings == [], [f.render() for f in findings]


def test_repo_host_code_clean():
    """The static host-sync pass over the port's driver code (serving
    loop, sessions, engine, obs) is clean."""
    findings = hostsync.run_files()
    assert findings == [], "\n".join(f.render() for f in findings)
    assert all(p.startswith("src/repro_torch/") for p in
               hostsync.DEFAULT_GLOBS)
