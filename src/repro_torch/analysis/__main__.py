"""CLI: ``python -m repro_torch.analysis [--device cpu] [--ci]
[--update-baseline] [...]`` (port of ``python -m repro.analysis``).

The matrix runs on ``--device``: the card by default, which raises on a
machine without one (``--device cpu`` runs the kernels' plain versions).
On the card the default cells are the GQA ones (``targets.CARD_TARGETS``);
an MLA cell named with ``--targets`` is refused there.
Default mode prints the findings report (use ``--report`` to persist the
JSON). ``--ci`` compares against the checked-in baselines
(``analysis_baseline_torch.json`` for findings,
``cost_baseline_torch.json`` for the cost pass's per-entry metrics, both
at the repo root; the reference's two files are its own) and exits 1 on
any NEW finding. ``--update-baseline`` regenerates both files from this
run and prints exactly what changed: audit the diff before committing.
The cost metrics are the same on every device (shapes times formulas).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import PASSES, analyze, compare_to_baseline
from repro_torch.analysis.hostsync import repo_root
from repro_torch.analysis.report import load_baseline
from repro_torch.analysis.targets import default_targets


def update_baselines(report, args) -> int:
    """``--update-baseline``: persist this run as the accepted state.

    * ``cost_baseline_torch.json`` — per-entry metrics from the cost
      pass, merged with existing rows for cells outside this run (so a
      ``--targets`` subset refresh can't drop the rest of the matrix);
    * ``analysis_baseline_torch.json`` — every non-COST005 finding of this
      run
      (COST005 is drift vs the cost baseline being rewritten, so it
      resolves by construction).

    Prints exactly what changed; audit the diff before committing. A
    non-empty findings baseline is loudly flagged — accepting a contract
    violation should be a deliberate, reviewed act.
    """
    import json

    root = repo_root()
    if report.metrics:
        from repro_torch.analysis.cost import (diff_cost_baseline,
                                               load_cost_baseline,
                                               write_cost_baseline)
        cost_path = root / "cost_baseline_torch.json"
        old = load_cost_baseline(str(cost_path))
        lines = diff_cost_baseline(report.metrics, old)
        write_cost_baseline(report.metrics, str(cost_path), merge_with=old)
        if lines:
            print(f"wrote {cost_path} ({len(lines)} change(s)):")
            for ln in lines:
                print(ln)
        else:
            print(f"wrote {cost_path} (no metric changes)")

    findings_path = (args.baseline
                     or str(root / "analysis_baseline_torch.json"))
    keep = [f for f in report.findings if f.code != "COST005"]
    old_keys = load_baseline(findings_path)
    new_keys = {f.key for f in keep}
    for key in sorted(new_keys - old_keys):
        print(f"  + accepting finding {key}")
    for key in sorted(old_keys - new_keys):
        print(f"  - dropping stale baseline entry {key}")
    comment = ("Accepted findings for `python -m repro_torch.analysis "
               "--ci`. EMPTY: the port's hot paths are clean. Regenerate "
               "with --update-baseline and audit the printed diff.")
    with open(findings_path, "w") as fh:
        json.dump({"version": 1,
                   "_comment": comment,
                   "findings": [dict(f.to_dict(),
                                     why="accepted by --update-baseline; "
                                         "see the PR that committed this")
                                for f in keep]}, fh, indent=2)
        fh.write("\n")
    print(f"wrote {findings_path} ({len(keep)} accepted finding(s))")
    if keep:
        print("WARNING: the findings baseline is NOT empty — each entry "
              "above is a live contract violation CI will now ignore. "
              "Make sure every one is deliberate.")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--device", default=None,
                    help="where the matrix runs: cuda (the default; raises "
                         "without a card) or cpu")
    ap.add_argument("--ci", action="store_true",
                    help="compare against the baseline; exit 1 on any NEW "
                         "finding")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write analysis_baseline_torch.json + "
                         "cost_baseline_torch.json from this run and print "
                         "the diff (audit it before committing)")
    ap.add_argument("--targets", default=None,
                    help=f"comma-separated subset of "
                         f"{','.join(default_targets('cpu'))} (default: "
                         f"the cells that run on --device; on the card "
                         f"{','.join(default_targets('cuda'))})")
    ap.add_argument("--passes", default=None,
                    help=f"comma-separated subset of {','.join(PASSES)}")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the machine-readable findings JSON here")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="baseline file (default: "
                         "analysis_baseline_torch.json at the repo root)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    targets = args.targets.split(",") if args.targets else None
    passes = args.passes.split(",") if args.passes else PASSES
    progress = (None if args.quiet else
                lambda s: print(f"  analyzing {s} ...", file=sys.stderr))
    report = analyze(targets, passes, progress=progress,
                     device=args.device)
    if args.report:
        report.write(args.report)
    print(report.render())

    if args.update_baseline:
        return update_baselines(report, args)

    if not args.ci:
        return 0
    baseline = (args.baseline
                or str(repo_root() / "analysis_baseline_torch.json"))
    diff = compare_to_baseline(report, baseline)
    if diff.accepted:
        print(f"{len(diff.accepted)} finding(s) accepted by baseline")
    for key in diff.stale:
        print(f"stale baseline entry (no longer reproduces, prune it): "
              f"{key}")
    if diff.new:
        print(f"\n{len(diff.new)} NEW finding(s) not in {baseline}:")
        for f in diff.new:
            print(f.render())
        return 1
    print("analysis gate: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
