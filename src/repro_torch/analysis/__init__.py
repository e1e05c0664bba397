"""repro_torch.analysis: static + runtime contract checker for the port's
engine hot path (port of ``repro.analysis``).

Five passes over every entry of ``SOIEngine.analysis_entries`` (and the
host driver code around them), each enforcing one serving contract:

* ``donation``   — decode-state leaves are written in place: none of at
                   least ``BIG_BYTES`` comes back in other storage, and no
                   live leaf is rebound under serving traffic (DON0xx);
* ``hostsync``   — no implicit device->host transfer inside a per-step
                   loop: one batched explicit drain per step, deferred one
                   step so it overlaps dispatched compute (SYNC0xx; AST
                   pass + runtime tripwires);
* ``retrace``    — O(1) captured graphs under normal traffic; repeat
                   traffic captures nothing (RET0xx);
* ``dtype``      — the carried decode state is a dtype fixed point, and no
                   narrowing or f64 hides in the step (DT0xx);
* ``cost``       — the paper's complexity claims hold on the port's own
                   program, metered op by op with the hand kernels priced
                   in closed form: off-phase cheaper than phase-0 by the
                   middle trunk's floor, paged bytes bounded vs dense, the
                   speculative window within its K-step identity, prefix
                   hits O(suffix), and no FLOP/byte drift beyond the
                   checked-in ``cost_baseline_torch.json`` (COST0xx).

Run ``python -m repro_torch.analysis --device cpu`` for the report on the
CPU (the default device is the card, which raises without one), ``--ci``
to gate on the checked-in baselines (``analysis_baseline_torch.json`` +
``cost_baseline_torch.json``), ``--update-baseline`` to regenerate both
after an audited change.
"""

from __future__ import annotations

from repro_torch.analysis.report import (BaselineDiff, Finding, Report,
                                         compare_to_baseline, load_baseline)
from repro_torch.analysis.targets import (AnalysisTarget, build_target,
                                          check_device, default_targets,
                                          drive_traffic, get_target)

PASSES = ("donation", "hostsync", "retrace", "dtype", "cost")


def run_pass(pass_name: str, target) -> list:
    if pass_name == "donation":
        from repro_torch.analysis import donation
        return donation.run(target)
    if pass_name == "hostsync":
        from repro_torch.analysis import hostsync, runtime
        return hostsync.run() + runtime.run(target)
    if pass_name == "retrace":
        from repro_torch.analysis import retrace
        return retrace.run(target)
    if pass_name == "dtype":
        from repro_torch.analysis import dtype_drift
        return dtype_drift.run(target)
    if pass_name == "cost":
        # single-target shape: in-cell certifications + baseline rows only;
        # cross-cell checks (COST002/COST003) need the matrix — see analyze()
        from repro_torch.analysis import cost
        return cost.run(target)
    raise ValueError(f"unknown pass {pass_name!r} (have {PASSES})")


def analyze(target_names=None, passes=PASSES, progress=None,
            device=None, baseline_path=None) -> Report:
    """Run ``passes`` over ``target_names`` on ``device`` (default: the
    card; raises without one). The default targets are the cells that run
    there (``default_targets``); a cell the card cannot run is refused
    before any pass starts.

    The static half of ``hostsync`` is target-independent and runs once.
    The ``cost`` pass runs once over the whole invocation AFTER the
    per-target loop (its COST002/COST003 certifications compare sibling
    cells) and deposits per-entry metrics in ``Report.metrics``;
    ``baseline_path`` is its COST005 baseline (None: the checked-in
    ``cost_baseline_torch.json``; False: none). Returns a
    :class:`Report`.
    """
    from repro_torch import resolve_device
    from repro_torch.analysis import hostsync

    device = resolve_device(device)
    target_names = list(target_names or default_targets(device))
    for name in target_names:
        check_device(name, device)
    passes = list(passes)
    report = Report(targets=target_names, passes=passes)
    if "hostsync" in passes:
        report.extend(hostsync.run())
    per_target = [p for p in passes if p != "cost"]
    for name in target_names:
        target = get_target(name, device)
        for pass_name in per_target:
            if progress:
                progress(f"{name}:{pass_name}")
            if pass_name == "hostsync":
                from repro_torch.analysis import runtime
                report.extend(runtime.run(target))
            else:
                report.extend(run_pass(pass_name, target))
    if "cost" in passes:
        from repro_torch.analysis import cost
        if progress:
            progress("cost:matrix")
        findings, metrics = cost.run_matrix(target_names, baseline_path,
                                            device=device)
        report.extend(findings)
        report.metrics = metrics
    report.dedupe()
    return report


__all__ = ["AnalysisTarget", "BaselineDiff", "Finding", "PASSES", "Report",
           "analyze", "build_target", "check_device", "compare_to_baseline",
           "default_targets", "drive_traffic", "get_target", "load_baseline",
           "run_pass"]
