"""Retrace-trigger lint (RET0xx) — port of ``repro.analysis.retrace``.

The reference's budget under normal traffic is O(1) compiled programs per
entry. The port compiles nothing at run time: its prefill, insert and
release run eagerly (the reference's prefill-compile counter has no
counterpart), and what a retrace costs the reference — a multi-second
stall — a new graph capture costs the port: the generate step captures one
CUDA graph a SOI branch, a speculative window one a window key. Two
checks:

* **static** (RET002): example args of every ``GraphEntry`` are scanned
  for Python scalars / numpy generics in non-static positions. A graph
  captures the value such an argument had at capture time and replays it
  forever; an eager entry reads it on the host, where it belongs among the
  static arguments;
* **dynamic** (RET001): the scripted traffic runs TWICE — first from
  ``init_decode_state`` (which drops the graphs: they were captured over
  the old state), then again on the live state. The first round may
  capture at most one graph a branch the entry can take; the repeat round
  must capture nothing (``CheckedGraph.keys()``: captures on the card, the
  branches the card would capture on the CPU).
"""

from __future__ import annotations

import numbers

import numpy as np

from repro_torch.analysis import targets as T
from repro_torch.analysis.report import Finding


def _static_scan(target_name, entry) -> list:
    findings = []
    for argnum, arg in enumerate(entry.args):
        if argnum in entry.static_args:
            continue
        if isinstance(arg, (bool, numbers.Number, np.generic)):
            findings.append(Finding(
                "retrace", "RET002", f"{target_name}:{entry.name}:arg{argnum}",
                f"Python scalar {type(arg).__name__} passed in a non-static "
                f"position — a captured graph bakes its value in and "
                f"replays it for every later value; pass it as a tensor the "
                f"step reads, or declare the position static"))
    return findings


def _budget(engine, name: str) -> int:
    """Graphs an entry may capture in one round: one a branch key."""
    if engine.cfg.soi is None:
        return 1
    if name == "speculative_window":
        return 2 ** engine.speculate
    return 2


def run(target) -> list:
    engine, params = target.engine, target.params
    findings = []
    entries = engine.analysis_entries(params)
    for entry in entries:
        findings.extend(_static_scan(target.name, entry))
    graphs = {e.name: e.graph for e in entries if e.graph is not None}

    rounds = []
    for fresh in (True, False):
        T.drive_traffic(target, fresh=fresh)
        rounds.append({n: len(g.keys()) for n, g in graphs.items()})
    first, steady = rounds

    for name in graphs:
        budget = _budget(engine, name)
        if first[name] > budget:
            findings.append(Finding(
                "retrace", "RET001", f"{target.name}:{name}",
                f"{first[name]} graphs captured under first-round traffic "
                f"(budget {budget}, one a branch) — the graph key varies "
                f"with per-request data"))
        growth = steady[name] - first[name]
        if growth > 0:
            findings.append(Finding(
                "retrace", "RET001", f"{target.name}:{name}",
                f"{growth} graphs captured on a REPEAT of identical "
                f"traffic — steady-state serving keeps capturing"))
    return findings
