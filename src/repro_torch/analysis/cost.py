"""The ``cost`` pass: SOI's FLOP/byte claims certified on the port's own
program (port of ``repro.analysis.cost``).

Every entry of every matrix cell (``SOIEngine.analysis_entries``) is run
once, eagerly, under :class:`~repro_torch.analysis.meter.Meter`. The
reference's generate is ONE compiled program whose ``lax.cond`` its HLO
parser charges twice — the most expensive branch (phase 0, the middle
runs) and the cheapest (off-phase, the middle skipped). The port's
generate is one CUDA graph a branch, so the pass meters each branch of
the entry (``GraphEntry.branches``) and gets the same two numbers:
``flops``/``bytes`` the phase-0 branch, ``flops_min``/``bytes_min`` the
off-phase one. The counts are shapes times formulas (the meter's
docstring): the CPU, fake tensors and the card give the same.

``METRIC_KEYS`` are ``flops``, ``flops_min``, ``bytes``, ``bytes_min``:
the reference also keeps XLA's ``peak_bytes``, which has no device-free
counterpart here — the allocator's peak depends on the device and its
caching allocator — so it stays out of ``cost_baseline_torch.json``.
``EntryCost.peak_bytes`` holds the measured peak on the card (None on the
CPU), and ``chip_smoke.py`` prints it.

Finding codes (family COST, the reference's codes, tolerances and
messages):

  COST001  off-phase generate FLOPs are NOT below phase-0 by at least the
           middle trunk's closed-form matmul floor — the SOI skip was lost
           (the middle leaked into the always-run path). Spec windows must
           bank K skips.
  COST002  paged generate touches more than ``PAGED_BYTES_TOL``x the bytes
           of its dense sibling — a dense-view gather crept back into the
           paged step.
  COST003  the fused speculative window costs more than its exact identity
           bound: (K-1) draft (off-phase) steps + K verify (worst-case
           phase-0) steps of the non-speculative sibling cell.
  COST004  a prefix-cache hit is not O(suffix): ``hydrate`` must contain
           zero matmul FLOPs (it is a pure page gather) and move fewer
           bytes than ONE prefill chunk.
  COST005  drift vs the checked-in ``cost_baseline_torch.json``: an
           entry's FLOPs/bytes grew beyond the baseline tolerance, or a new
           entry has no baseline row. Regenerate with ``python -m
           repro_torch.analysis --device cpu --update-baseline`` after
           auditing the diff it prints.

Certifications that compare cells (COST002/COST003) run only when the
sibling cell is part of the same invocation.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.analysis.meter import Meter, tensors_of
from repro_torch.analysis.report import Finding

PASS = "cost"

# the reference's bounds (repro/analysis/cost.py)
SPEC_WINDOW_TOL = 1.02   # window vs (K-1)*off + K*p0
PAGED_BYTES_TOL = 1.25   # paged/dense generate bytes
BASELINE_TOL = 0.10      # default headroom for COST005 growth

METRIC_KEYS = ("flops", "flops_min", "bytes", "bytes_min")


@dataclasses.dataclass(frozen=True)
class EntryCost:
    """Cost of one entry: ``flops``/``bytes`` of its most expensive branch
    (phase 0), the ``_min`` variants of its cheapest (off-phase); an entry
    without branches has both equal. ``peak_bytes``: the allocator's peak
    over the metered run on the card (bytes above what was allocated
    before it), None on the CPU. ``kernels``: priced kernel calls per
    name, of the phase-0 branch."""
    flops: float
    flops_min: float
    bytes: float
    bytes_min: float
    peak_bytes: float | None = None
    contract: dict | None = None
    kernels: dict | None = None

    def to_metrics(self) -> dict:
        return {k: getattr(self, k) for k in METRIC_KEYS}


def _on_cuda(args) -> torch.device | None:
    for t in tensors_of(args):
        if t.is_cuda:
            return t.device
    return None


def meter_call(fn, args) -> tuple:
    """``(meter, peak_bytes)`` of one eager call ``fn(*args)``; the peak
    is measured on the card only (None otherwise)."""
    dev = _on_cuda(args)
    if dev is not None:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    with Meter() as m:
        fn(*args)
    peak = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = float(torch.cuda.max_memory_allocated(dev) - base)
    return m, peak


def require_priced(where: str, *meters) -> None:
    """Raise if any meter saw a kernel call with no registered closed-form
    cost: its FLOPs/bytes would silently vanish from every COST bound."""
    unpriced: set = set()
    for m in meters:
        unpriced |= set(m.unpriced_kernels)
    if unpriced:
        raise ValueError(
            f"{where}: kernel calls with no registered closed-form cost: "
            f"{sorted(unpriced)} — add them to "
            f"src/repro_torch/kernels/costs.py (KERNEL_COSTS)")


def measure_entry(entry, where: str = "") -> EntryCost:
    """Meter every branch of ``entry`` once (its ``args`` when it has
    none); phase-0 = the branch with the most FLOPs, off-phase the
    fewest."""
    argsets = ([entry.with_branch(b) for b in entry.branches]
               if entry.branches else [entry.args])
    runs = [meter_call(entry.fn, a) for a in argsets]
    require_priced(where or entry.name, *(m for m, _ in runs))
    hi = max(runs, key=lambda r: r[0].flops)
    lo = min(runs, key=lambda r: r[0].flops)
    peaks = [p for _, p in runs if p is not None]
    return EntryCost(flops=hi[0].flops, flops_min=lo[0].flops,
                     bytes=hi[0].bytes, bytes_min=lo[0].bytes,
                     peak_bytes=max(peaks) if peaks else None,
                     contract=entry.cost, kernels=dict(hi[0].kernels))


_COST_CACHE: dict = {}


def measure_target(target) -> dict:
    """entry name -> :class:`EntryCost` for every entry of the target's
    engine. Cached per target (engine construction and the eager runs
    dominate)."""
    key = (target.name, str(target.engine.device))
    if key in _COST_CACHE:
        return _COST_CACHE[key]
    out = {e.name: measure_entry(e, f"{target.name}.{e.name}")
           for e in target.engine.analysis_entries(target.params)}
    _COST_CACHE[key] = out
    return out


def measure_engine(cfg, engine_kwargs: dict, *, params=None, device=None,
                   fake: bool = False, names=("generate",)) -> dict:
    """entry name -> :class:`EntryCost` for the entries ``names`` of an
    engine built from ``cfg`` and ``engine_kwargs`` (any width: the
    full-width cells of ``chip_smoke.py``). ``fake=True`` meters it on the
    CPU under ``FakeTensorMode`` — random-free shapes, nothing allocated;
    otherwise on ``device`` with ``params`` (the card's real run)."""
    from repro_torch.engine.soi_engine import SOIEngine

    def measure(params, device):
        engine = SOIEngine(cfg, device=device, **engine_kwargs)
        return {e.name: measure_entry(e, e.name)
                for e in engine.analysis_entries(params)
                if e.name in names}
    if not fake:
        return measure(params, device)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.plan import _fake_params
    with FakeTensorMode():
        return measure(_fake_params(cfg), "cpu")


def middle_trunk_floor(cfg, batch: int) -> float:
    """Closed-form LOWER bound on the per-step matmul FLOPs of the SOI
    middle trunk: the projections/MLPs a phase-0 step must run and an
    off-phase step must skip, for ``batch`` decoding slots (the
    reference's closed form).

    Deliberately conservative — only unconditional matmuls are counted
    (GQA q/k/v/o projections, dense MLP matmuls, routed+shared expert
    matmuls at top_k occupancy); attention score/value products, norms and
    MLA's absorbed low-rank path are left out. The certified gap
    (phase-0 − off-phase) must STILL clear this floor."""
    from repro_torch.models.transformer import soi_partition

    if cfg.soi is None:
        return 0.0
    _, mid, _ = soi_partition(cfg)
    d = cfg.d_model
    per_tok = 0.0
    for seg in mid:
        for i in range(seg.n_layers):
            blk = seg.blocks[i % len(seg.blocks)]
            a = blk.attn
            if a is not None and not a.is_mla:
                # q + k + v + o projections, per token
                per_tok += 2.0 * d * a.head_dim * (2 * a.n_heads + 2 * a.n_kv)
            if blk.mlp is not None and blk.mlp.d_ff:
                mults = 3 if blk.mlp.kind in ("swiglu", "geglu") else 2
                per_tok += mults * 2.0 * d * blk.mlp.d_ff
            if blk.moe is not None:
                m = blk.moe
                mults = 3 if m.mlp_kind in ("swiglu", "geglu") else 2
                per_tok += m.top_k * mults * 2.0 * d * m.d_expert
                per_tok += m.n_shared * mults * 2.0 * d * m.d_shared
    return per_tok * batch


def load_cost_baseline(path: str):
    """Parsed cost baseline, or ``None`` when the file is absent (COST005
    then reports every entry as missing — run ``--update-baseline``)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None


def write_cost_baseline(metrics: dict, path: str,
                        tolerance: float = BASELINE_TOL,
                        merge_with=None) -> dict:
    """Write ``cost_baseline_torch.json`` from a run's metrics.
    ``merge_with`` (an existing parsed baseline) preserves rows for cells
    NOT in this run."""
    cells = dict((merge_with or {}).get("cells", {}))
    for tname, entries in metrics.items():
        cells[tname] = {e: {k: m[k] for k in METRIC_KEYS}
                        for e, m in entries.items()}
    data = {"version": 1, "tolerance": tolerance,
            "cells": {k: cells[k] for k in sorted(cells)}}
    with open(path, "w") as fh:
        json.dump(data, fh, indent=2)
        fh.write("\n")
    return data


def diff_cost_baseline(metrics: dict, baseline) -> list:
    """Human-readable per-metric changes vs a parsed baseline (for the
    ``--update-baseline`` printout)."""
    lines = []
    old_cells = (baseline or {}).get("cells", {})
    for tname in sorted(metrics):
        base_entries = old_cells.get(tname, {})
        for ename in sorted(metrics[tname]):
            where = f"{tname}.{ename}"
            if ename not in base_entries:
                lines.append(f"  + {where} (new entry)")
                continue
            for k in METRIC_KEYS:
                new = metrics[tname][ename].get(k, 0.0)
                old = base_entries[ename].get(k, 0.0)
                if new != old:
                    pct = 100.0 * (new - old) / old if old else float("inf")
                    lines.append(f"  ~ {where}.{k}: {old:,.0f} -> "
                                 f"{new:,.0f} ({pct:+.1f}%)")
        for ename in sorted(set(base_entries) - set(metrics[tname])):
            lines.append(f"  - {tname}.{ename} (entry gone)")
    return lines


def _find(code, where, message):
    return Finding(pass_name=PASS, code=code, where=where, message=message)


def _certify_cell(name, costs, cfg) -> list:
    """In-cell assertions: COST001 (off-phase skip) and COST004 (prefix
    hit is O(suffix))."""
    findings = []
    for ename, c in costs.items():
        ct = c.contract or {}
        role = ct.get("role")
        if role in ("generate", "spec_window") and cfg.soi is not None:
            mult = ct.get("k", 1) if role == "spec_window" else 1
            floor = middle_trunk_floor(cfg, ct.get("batch", 1)) * mult
            gap = c.flops - c.flops_min
            if gap + 0.5 < floor:
                findings.append(_find(
                    "COST001", f"{name}.{ename}",
                    f"off-phase skip lost: phase-0 "
                    f"{c.flops:,.0f} FLOPs vs off-phase {c.flops_min:,.0f} "
                    f"(gap {gap:,.0f}) — the middle trunk's matmul floor "
                    f"is {floor:,.0f} for stride {ct.get('stride')} "
                    f"batch {ct.get('batch')}"
                    + (f" x K={ct['k']} skips" if mult > 1 else "")))
        if role == "hydrate":
            if c.flops > 0.5:
                findings.append(_find(
                    "COST004", f"{name}.{ename}",
                    f"prefix-cache hydrate contains {c.flops:,.0f} matmul "
                    f"FLOPs — a hit must be a pure page gather, not "
                    f"recompute"))
            chunk = costs.get("prefill_chunk")
            if chunk is not None and c.bytes >= chunk.bytes:
                findings.append(_find(
                    "COST004", f"{name}.{ename}",
                    f"hydrate moves {c.bytes:,.0f} bytes >= one prefill "
                    f"chunk's {chunk.bytes:,.0f} — a prefix hit is not "
                    f"O(suffix)"))
    return findings


def _step_entry(costs):
    """The cell's decode-step entry: ``generate`` or the fused window."""
    for ename in ("generate", "speculative_window"):
        if ename in costs:
            return ename, costs[ename]
    return None, None


def _certify_cross(all_costs: dict) -> list:
    """Cross-cell assertions, for every pair present in this run:
    COST002 (paged bytes vs dense sibling) and COST003 (spec window vs
    the per-token identity of the non-spec sibling)."""
    findings = []
    for name, costs in all_costs.items():
        ename, step = _step_entry(costs)
        if step is None:
            continue
        # COST002: -paged vs -dense, same arch / same spec mode
        if "-paged" in name:
            sib = all_costs.get(name.replace("-paged", "-dense"))
            if sib is not None:
                _, dense = _step_entry(sib)
                if dense is not None and dense.bytes > 0 \
                        and step.bytes > PAGED_BYTES_TOL * dense.bytes:
                    findings.append(_find(
                        "COST002", f"{name}.{ename}",
                        f"paged step touches {step.bytes:,.0f} bytes = "
                        f"{step.bytes / dense.bytes:.2f}x its dense "
                        f"sibling's {dense.bytes:,.0f} (bound "
                        f"{PAGED_BYTES_TOL}x) — a dense-view gather is "
                        f"back on the paged path"))
        # COST003: the fused window vs K per-token steps of the sibling
        k = (step.contract or {}).get("k")
        if ename == "speculative_window" and k and name.endswith("-spec"):
            sib = all_costs.get(name[:-len("-spec")])
            if sib is not None and "generate" in sib:
                g = sib["generate"]
                bound = (k - 1) * g.flops_min + k * g.flops
                if step.flops > SPEC_WINDOW_TOL * bound:
                    findings.append(_find(
                        "COST003", f"{name}.{ename}",
                        f"fused speculative window costs {step.flops:,.0f} "
                        f"FLOPs > {SPEC_WINDOW_TOL}x its identity bound "
                        f"{bound:,.0f} = (K-1) off-phase drafts + K "
                        f"worst-case verify steps of {name[:-5]} (K={k})"))
    return findings


def _certify_baseline(metrics: dict, baseline) -> list:
    """COST005: growth beyond tolerance, or entries with no baseline row.
    Shrinkage never fails — it only means the baseline is refreshable."""
    findings = []
    cells = (baseline or {}).get("cells", {})
    tol = (baseline or {}).get("tolerance", BASELINE_TOL)
    for tname, entries in metrics.items():
        base_entries = cells.get(tname, {})
        for ename, m in entries.items():
            where = f"{tname}.{ename}"
            base = base_entries.get(ename)
            if base is None:
                findings.append(_find(
                    "COST005", where,
                    "no cost baseline row for this entry — run `python -m "
                    "repro_torch.analysis --device cpu --update-baseline`, "
                    "audit the printed diff, and commit "
                    "cost_baseline_torch.json"))
                continue
            grown = [f"{k} {base[k]:,.0f} -> {m[k]:,.0f} "
                     f"(+{100.0 * (m[k] - base[k]) / base[k]:.1f}%)"
                     for k in METRIC_KEYS
                     if base.get(k, 0.0) > 0 and m[k] > base[k] * (1 + tol)]
            if grown:
                findings.append(_find(
                    "COST005", where,
                    f"cost regression beyond the {tol:.0%} baseline "
                    f"tolerance: " + "; ".join(grown)))
    return findings


def run_matrix(target_names, baseline_path=None, device=None):
    """Measure + certify ``target_names`` on ``device``. Returns
    ``(findings, metrics)`` where ``metrics`` is ``{target: {entry:
    {flops, flops_min, bytes, bytes_min}}}`` — the payload
    ``--update-baseline`` persists. ``baseline_path=None`` resolves
    ``cost_baseline_torch.json`` at the repo root; pass ``False`` to skip
    COST005 entirely."""
    from repro_torch.analysis.targets import get_target

    all_costs, metrics = {}, {}
    for name in target_names:
        t = get_target(name, device)
        all_costs[name] = measure_target(t)
        metrics[name] = {e: c.to_metrics()
                         for e, c in all_costs[name].items()}
    findings = []
    for name, costs in all_costs.items():
        findings += _certify_cell(name, costs, get_target(name, device).cfg)
    findings += _certify_cross(all_costs)
    if baseline_path is not False:
        if baseline_path is None:
            from repro_torch.analysis.hostsync import repo_root
            baseline_path = str(repo_root() / "cost_baseline_torch.json")
        findings += _certify_baseline(metrics,
                                      load_cost_baseline(baseline_path))
    return findings, metrics


def run(target) -> list:
    """Single-target entry point (the ``run_pass`` shape): in-cell
    certifications + baseline rows for this cell only. Cross-cell checks
    need the matrix — use :func:`run_matrix` (``analyze`` does)."""
    return run_matrix([target.name], device=target.engine.device)[0]
