"""Dtype-drift checker (DT0xx) — port of ``repro.analysis.dtype_drift``.

The decode state is a long-lived carry: a single promotion or narrowing
inside one step compounds across thousands of steps (silent precision
loss) or doubles cache memory (silent f32 upcast of a bf16 ring). The
reference walks each entry's jaxpr; the port has no jaxpr, so it audits
one eager run of each ``GraphEntry`` under a ``TorchDispatchMode`` that
sees every aten op:

* **carry stability** (DT001): for entries that thread the decode state
  through (``carry=(in_argnum, out_index)``), every state leaf's dtype and
  shape after the step must equal the same leaf's before it, and the tree
  must keep its leaves — the carry is a fixed point (a captured graph
  replays over exactly these tensors);
* **narrowing** (DT002): a float conversion (``_to_copy`` or a copy into a
  narrower tensor) below the config's compute dtype — e.g. an accidental
  f32 -> bf16 round-trip inside an f32 config's step;
* **f64** (DT003): any float64 value anywhere in the step (a Python float
  or a numpy default promoting it doubles memory and breaks bit-exactness
  against the card's f32 kernels).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.meter import tensors_of
from repro_torch.analysis.report import Finding
from repro_torch.engine.contracts import state_leaves

aten = torch.ops.aten


def _float_itemsize(dtype) -> int:
    return dtype.itemsize if dtype.is_floating_point else 0


class _Audit(TorchDispatchMode):
    """Record narrowing conversions and f64 values of one run."""

    def __init__(self, compute_itemsize: int):
        super().__init__()
        self.compute_itemsize = compute_itemsize
        self.narrowing = set()      # {(src dtype, dst dtype)}
        self.f64 = []               # op names that saw a float64

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pkt = func.overloadpacket
        pair = None
        if pkt is aten._to_copy and kwargs.get("dtype") is not None:
            pair = (args[0].dtype, kwargs["dtype"])
        elif pkt is aten.copy_:
            pair = (args[1].dtype, args[0].dtype)
        if pair is not None:
            s_i, d_i = _float_itemsize(pair[0]), _float_itemsize(pair[1])
            if s_i and d_i and d_i < s_i and d_i < self.compute_itemsize:
                self.narrowing.add(pair)
        if any(t.dtype == torch.float64
               for t in tensors_of((args, kwargs)) + tensors_of(out)):
            self.f64.append(str(pkt))
        return out


def _snapshot(tree) -> list:
    return [(label, t.dtype, tuple(t.shape)) for label, t in
            state_leaves(tree)]


def check_entry(target_name, entry, compute_itemsize) -> list:
    """Run the entry once under the audit; carry, narrowing and f64."""
    where = f"{target_name}:{entry.name}"
    before = (_snapshot(entry.args[entry.carry[0]])
              if entry.carry is not None else None)
    audit = _Audit(compute_itemsize)
    try:
        with audit:
            out = entry.fn(*entry.args)
    except Exception as e:
        return [Finding("dtype", "DT002", where,
                        f"entry failed to run for dtype analysis: {e!r}")]
    findings = []
    for src, dst in sorted(audit.narrowing, key=str):
        findings.append(Finding(
            "dtype", "DT002", where,
            f"float narrowing {src} -> {dst} below the config compute "
            f"dtype inside the step"))
    if audit.f64:
        findings.append(Finding(
            "dtype", "DT003", where,
            f"float64 value inside the step (op {audit.f64[0]}, "
            f"{len(audit.f64)} ops) — f64 leaked into the hot path"))
    if before is not None:
        findings += _check_carry(where, entry, before, out)
    return findings


def _check_carry(where, entry, before, out) -> list:
    out_index = entry.carry[1]
    after = _snapshot(out if out_index is None else out[out_index])
    if [p for p, _, _ in after] != [p for p, _, _ in before]:
        return [Finding(
            "dtype", "DT001", where,
            f"carried state changes its leaves across the call "
            f"({len(before)} -> {len(after)}) — a captured graph replays "
            f"over the leaves it was captured with")]
    findings = []
    for (path, da, sa), (_, db, sb) in zip(before, after):
        if da != db or sa != sb:
            findings.append(Finding(
                "dtype", "DT001", f"{where}:{path}",
                f"carried state leaf drifts {da} {sa} -> {db} {sb}: the "
                f"next step sees a different leaf than this one ran on"))
    return findings


def run(target, entries=None) -> list:
    entries = (target.engine.analysis_entries(target.params)
               if entries is None else entries)
    compute_itemsize = getattr(torch, target.cfg.dtype).itemsize
    findings = []
    for entry in entries:
        findings.extend(check_entry(target.name, entry, compute_itemsize))
    return findings
