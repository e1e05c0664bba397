"""Findings, reports, and the CI baseline protocol for
``repro_torch.analysis`` (a copy of ``repro.analysis.report``).

A ``Finding`` is one contract violation: which pass raised it, a stable
machine code (``DON001`` ...), *where* (an engine entry like
``gqa-paged._gen`` or a ``file:line`` for AST findings), and a human
message. ``where`` + ``code`` form the identity used for baseline
comparison, so message details (byte counts, cache sizes) may drift without
churning the baseline.

The CI protocol (``python -m repro_torch.analysis --ci``):

* run every pass over every target;
* compare the findings against the checked-in baseline
  (``analysis_baseline_torch.json`` at the repo root — EMPTY once the
  hot paths are clean);
* exit 1 on any finding not in the baseline (new contract violation), exit
  0 otherwise. Stale baseline entries (accepted findings that no longer
  reproduce) are reported but do not fail the build — prune them when
  convenient.

Accepting a finding = adding its ``{"pass": ..., "code": ..., "where":
...}`` triple to the baseline file with a short justification in the
``"why"`` field (ignored by the comparison, read by humans).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

# Stable finding codes, one family per pass:
#   DON001  large state buffer not donated
#   DON002  a state leaf >= BIG_BYTES did not come back in its own storage
#           (CheckedGraph's DroppedDonationError)
#   DON003  a live decode-state leaf rebound while serving (a captured
#           graph would read stale storage)
#   SYNC001 implicit device->host transfer inside a per-step loop (AST)
#   SYNC002 implicit device->host transfer at runtime (instrumented)
#   SYNC003 same-iteration result drain (blocks overlap with the next step)
#   RET001  graph captures / prefill compiles beyond the O(1) contract
#   RET002  Python scalar in a non-static position (a graph bakes it in)
#   DT001   carried-state dtype drift (output leaf dtype != input leaf)
#   DT002   narrowing float conversion below the config compute dtype
#   DT003   float64 on a bit-exactness path
#   COST001 off-phase generate not cheaper than phase-0 by the middle floor
#   COST002 paged generate bytes beyond the dense-sibling bound
#   COST003 fused speculative window above its K-step identity bound
#   COST004 prefix-cache hydrate recomputes (not a pure O(suffix) gather)
#   COST005 FLOPs/bytes drift beyond cost_baseline_torch.json tolerance


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str          # "donation" | "host-sync" | "retrace" | "dtype"
    code: str               # stable machine code (see table above)
    where: str              # "<target>.<entry>" or "path/to/file.py:line"
    message: str            # human explanation, free to drift
    severity: str = "error"

    @property
    def key(self) -> tuple:
        return (self.pass_name, self.code, self.where)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"[{self.pass_name}:{self.code}] {self.where}\n"
                f"    {self.message}")


@dataclasses.dataclass
class Report:
    findings: List[Finding] = dataclasses.field(default_factory=list)
    targets: List[str] = dataclasses.field(default_factory=list)
    passes: List[str] = dataclasses.field(default_factory=list)
    # per-entry static cost metrics from the ``cost`` pass:
    # {target: {entry: {flops, flops_min, bytes, bytes_min}}}
    # — the payload ``--update-baseline`` writes to
    # cost_baseline_torch.json.
    metrics: dict = dataclasses.field(default_factory=dict)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def dedupe(self) -> None:
        """Collapse findings with identical keys (e.g. the same static
        host-sync line reached via two pass invocations) to the first."""
        seen, kept = set(), []
        for f in self.findings:
            if f.key not in seen:
                seen.add(f.key)
                kept.append(f)
        self.findings = kept

    def to_dict(self) -> dict:
        out = {"version": 1,
               "targets": self.targets,
               "passes": self.passes,
               "findings": [f.to_dict() for f in self.findings]}
        if self.metrics:
            out["metrics"] = self.metrics
        return out

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)
            fh.write("\n")

    def render(self) -> str:
        if not self.findings:
            return (f"repro_torch.analysis: 0 findings across "
                    f"{len(self.targets)} target(s), "
                    f"passes: {', '.join(self.passes)}")
        lines = [f"repro_torch.analysis: {len(self.findings)} "
                 f"finding(s):"]
        lines += [f.render() for f in self.findings]
        return "\n".join(lines)


def load_baseline(path: str) -> set:
    """Accepted finding keys from a checked-in baseline file. A missing
    baseline is an empty baseline (everything is a new finding)."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return set()
    return {(f["pass_name"], f["code"], f["where"])
            for f in data.get("findings", [])}


@dataclasses.dataclass
class BaselineDiff:
    new: List[Finding]
    accepted: List[Finding]
    stale: List[tuple]

    @property
    def clean(self) -> bool:
        return not self.new


def compare_to_baseline(report: Report,
                        baseline_path: Optional[str]) -> BaselineDiff:
    base = load_baseline(baseline_path) if baseline_path else set()
    new = [f for f in report.findings if f.key not in base]
    accepted = [f for f in report.findings if f.key in base]
    seen = {f.key for f in report.findings}
    stale = sorted(k for k in base if k not in seen)
    return BaselineDiff(new=new, accepted=accepted, stale=stale)
