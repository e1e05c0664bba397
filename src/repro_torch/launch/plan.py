"""Capacity planner: what does serving a config cell cost on the card?
(port of ``repro.launch.plan``).

``plan_cell`` combines the per-entry costs certified by the ``cost``
analysis pass (FLOPs/bytes of the generate step, phase-0 and off-phase
branches separately; ``repro_torch.analysis.cost``) with a
:class:`HardwareSpec` roofline and the engine's state geometry to
predict, per cell:

  * seconds/step for phase-0 and off-phase, and the steady-state
    stride-average (1 phase-0 + stride-1 off-phase steps);
  * tokens/s at full occupancy (speculative cells: K committed tokens per
    window at full acceptance — the static upper bound);
  * device residency: params + decode-state caches, decode-state
    bytes/slot, and the max concurrent slots that fit the spec's memory;
  * the entry count (one program per engine entry — the O(1) contract).

The default spec is :data:`H100`, the card the port serves on;
:data:`TPU_V5E` is the reference's, kept so a test can hold ``plan_cell``
to the reference's field for field. The numbers come from
``cost_baseline_torch.json`` when it covers a cell (nothing runs) and are
measured live on the CPU otherwise; a full-width cell passes its own
``cfg``, ``engine_kwargs`` and metrics.

Honesty checks (``check_soi_bench`` / ``check_paged_bench`` /
``check_selfspec_bench``) compare a prediction with a measured bench.
The port has no bench file yet: ``run_honesty_checks`` and ``main`` take
the bench dicts as arguments and read no file.

CLI: ``PYTHONPATH=src python -m repro_torch.launch.plan [--cells a,b]
[--json]``.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip roofline + capacity numbers."""
    name: str
    peak_flops: float          # FLOP/s (bf16 dense peak)
    hbm_bw: float              # bytes/s
    hbm_bytes: float           # capacity, bytes
    link_bw: float             # bytes/s per chip-to-chip link
    hbm_reserve_frac: float = 0.10   # headroom for temps/workspace
    peak_flops_f32: float | None = None   # FLOP/s, f32 without tensor cores


TPU_V5E = HardwareSpec(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       hbm_bytes=16 * 2**30, link_bw=50e9)

# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet:
H100 = HardwareSpec(
    name="h100-sxm",
    # BF16 Tensor Core: 1,979 TFLOPS with sparsity, half that dense:
    # 989.4e12 = 132 SMs x 4096 dense bf16 FLOP/clock x 1.83 GHz boost
    peak_flops=989.4e12,
    # GPU memory bandwidth: 3.35 TB/s (HBM3)
    hbm_bw=3.35e12,
    # GPU memory: 80 GB of HBM3 (80 GiB on the part; CUDA reports a
    # little less as total_memory)
    hbm_bytes=80 * 2**30,
    # NVLink 4: 900 GB/s a GPU over 18 links, both directions
    link_bw=900e9 / 18,
    # FP32 (no tensor cores): 67 TFLOPS
    peak_flops_f32=67e12)


@dataclasses.dataclass(frozen=True)
class CellPlan:
    cell: str
    hardware: str
    stride: int
    k: int                       # speculation window (1 = per-token)
    batch: int                   # engine slots
    step_s_phase0: float
    step_s_offphase: float
    step_s_avg: float            # stride-average per committed token
    tok_s: float                 # batch * k-per-window / window, steady state
    param_bytes: float
    state_bytes_per_slot: float
    state_bytes_total: float
    hbm_resident_bytes: float    # params + caches at the cell's geometry
    max_slots: int               # slots that fit spec memory next to params
    compile_count: int           # one program per engine entry (O(1) contract)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _roofline_s(flops: float, nbytes: float, spec: HardwareSpec) -> float:
    return max(flops / spec.peak_flops, nbytes / spec.hbm_bw)


def _cell_shape(name: str, cfg=None, engine_kwargs=None):
    """(cfg, engine_kwargs, stride, k, batch) for a matrix cell, or for the
    ``cfg``/``engine_kwargs`` given — without building an engine."""
    if cfg is None:
        from repro_torch.analysis.targets import MATRIX
        cfg_fn, engine_kwargs = MATRIX[name]
        cfg = cfg_fn()
    stride = cfg.soi.stride if cfg.soi is not None else 1
    k = int(engine_kwargs.get("speculate") or 1)
    batch = int(engine_kwargs["max_concurrent_decodes"])
    return cfg, engine_kwargs, stride, k, batch


def load_cell_metrics(names, baseline_path=None) -> dict:
    """Per-entry cost metrics per matrix cell: from
    ``cost_baseline_torch.json`` when it covers the cell, measured live on
    the CPU otherwise."""
    from repro_torch.analysis import cost

    if baseline_path is None:
        from repro_torch.analysis.hostsync import repo_root
        baseline_path = str(repo_root() / "cost_baseline_torch.json")
    cells = ((cost.load_cost_baseline(baseline_path) or {})
             .get("cells", {}))
    out = {n: cells[n] for n in names if n in cells}
    missing = [n for n in names if n not in out]
    if missing:
        _, live = cost.run_matrix(missing, baseline_path=False,
                                  device="cpu")
        out.update(live)
    return out


def _fake_params(cfg):
    """The served params (cast to ``cfg.dtype``) as fake tensors: shapes
    and dtypes, nothing allocated. Call inside ``FakeTensorMode``."""
    import torch
    from repro_torch.models import transformer as T
    return T.init(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu", dtype=T._dtype(cfg))


def decode_state_leaves(cfg, engine_kwargs) -> list:
    """``(label, bytes)`` of every tensor of a fresh decode state:
    ``init_decode_state`` of a THROWAWAY engine under ``FakeTensorMode``
    (nothing executes, nothing allocates)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.engine.contracts import state_leaves
    from repro_torch.engine.soi_engine import SOIEngine

    with FakeTensorMode():
        engine = SOIEngine(cfg, device="cpu", **engine_kwargs)
        ds = engine.init_decode_state(_fake_params(cfg))
        return [(label, t.numel() * t.element_size())
                for label, t in state_leaves(ds)]


_CACHE_GROUPS = ("segments", "pre", "mid", "post")


def state_bytes_per_slot(cfg, engine_kwargs) -> float:
    """Static decode-state footprint a slot: the attention/recurrence
    cache groups (the reference's ``segments``/``pre``/``mid``/``post``) of
    a fresh decode state under ``FakeTensorMode`` — the counterpart of the
    reference's ``eval_shape`` over ``init_decode_state``."""
    total = sum(b for label, b in decode_state_leaves(cfg, engine_kwargs)
                if any(label.startswith(f"['model']['{g}']")
                       for g in _CACHE_GROUPS))
    return total / float(engine_kwargs["max_concurrent_decodes"])


def _param_bytes(cfg) -> float:
    """Bytes of the params as served (``cfg.dtype``; the smoke matrix's
    f32 configs hold what the reference's f32 masters hold)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = _fake_params(cfg)
        return float(sum(p.numel() * p.element_size()
                         for p in params.parameters()))


def plan_cell(name: str, spec: HardwareSpec = H100,
              metrics: dict | None = None, *, cfg=None,
              engine_kwargs=None) -> CellPlan:
    """Predict serving cost/capacity for one cell on ``spec``: a matrix
    cell by ``name``, or any engine given by ``cfg`` and
    ``engine_kwargs`` (then ``metrics`` is required)."""
    if metrics is None:
        metrics = load_cell_metrics([name])[name]
    cfg, kwargs, stride, k, batch = _cell_shape(name, cfg, engine_kwargs)
    step_name = ("speculative_window" if "speculative_window" in metrics
                 else "generate")
    step = metrics[step_name]
    # flops/bytes charge the phase-0 branch, the _min pair the off-phase
    # one. A speculative window already contains its K verify + K-1 draft
    # steps, so divide by K committed tokens (full acceptance).
    s_p0 = _roofline_s(step["flops"], step["bytes"], spec) / k
    s_off = _roofline_s(step["flops_min"], step["bytes_min"], spec) / k
    s_avg = (s_p0 + (stride - 1) * s_off) / stride
    pbytes = _param_bytes(cfg)
    per_slot = state_bytes_per_slot(cfg, kwargs)
    total_state = per_slot * batch
    avail = spec.hbm_bytes * (1.0 - spec.hbm_reserve_frac) - pbytes
    max_slots = int(avail // per_slot) if per_slot > 0 and avail > 0 else 0
    return CellPlan(
        cell=name, hardware=spec.name, stride=stride, k=k, batch=batch,
        step_s_phase0=s_p0, step_s_offphase=s_off, step_s_avg=s_avg,
        tok_s=batch / s_avg if s_avg > 0 else float("inf"),
        param_bytes=pbytes, state_bytes_per_slot=per_slot,
        state_bytes_total=total_state,
        hbm_resident_bytes=pbytes + total_state, max_slots=max_slots,
        compile_count=len(metrics))


def plan_matrix(names=None, spec: HardwareSpec = H100) -> dict:
    from repro_torch.analysis.targets import MATRIX
    names = list(names or MATRIX)
    metrics = load_cell_metrics(names)
    return {n: plan_cell(n, spec, metrics[n]) for n in names}


# ---- honesty checks: prediction vs a measured bench ----------------------


def _rel_err(pred: float, meas: float) -> float:
    return pred / meas - 1.0 if meas else float("inf")


def check_soi_bench(bench: dict) -> dict:
    """Planner's steady-state composition vs a measured SOI bench: the
    per-phase device-loop steps composed ``(phase0 + (stride-1) *
    offphase) / stride`` against the bench's separately measured
    phase-aligned loop."""
    stride = int(bench.get("stride", 2))
    batch = int(bench.get("batch", 4))
    pred_s = (bench["devloop_step_soi_phase0_s"]
              + (stride - 1) * bench["devloop_step_soi_offphase_s"]) / stride
    meas_s = bench["devloop_step_soi_aligned_s"]
    return {"what": "steady-state SOI tok/s (devloop)",
            "predicted_tok_s": batch / pred_s,
            "measured_tok_s": batch / meas_s,
            "rel_err": _rel_err(batch / pred_s, batch / meas_s)}


def check_paged_bench(bench: dict) -> list:
    """Static state-geometry bytes/slot vs a paged-KV bench's measured
    ``nbytes`` — dense and paged, at the bench's exact geometry."""
    import repro_torch.configs.qwen3_1_7b as Q
    from repro_torch.models import decode as D

    slots = int(bench["slots"])
    resident = int(bench["resident_batch"])
    max_len = int(bench["max_len"])
    page = int(bench["page_size"])
    cfg = dataclasses.replace(Q.smoke_config(soi="pp"), dtype="float32")
    outer_len, mid_len = D.paged_group_lens(cfg, max_len)
    pred_dense = state_bytes_per_slot(
        cfg, dict(max_concurrent_decodes=slots, max_len=max_len))
    pred_paged = state_bytes_per_slot(
        cfg, dict(max_concurrent_decodes=slots, max_len=max_len,
                  paged=True, page_size=page,
                  n_pages=resident * (outer_len // page) + 1,
                  n_pages_mid=resident * (mid_len // page) + 1))
    return [
        {"what": "dense decode-state bytes/slot",
         "predicted": pred_dense, "measured": bench["dense_bytes_per_slot"],
         "rel_err": _rel_err(pred_dense, bench["dense_bytes_per_slot"])},
        {"what": "paged decode-state bytes/slot",
         "predicted": pred_paged, "measured": bench["paged_bytes_per_slot"],
         "rel_err": _rel_err(pred_paged, bench["paged_bytes_per_slot"])},
    ]


def check_selfspec_bench(bench: dict) -> list:
    """O(1)-capture prediction vs a self-speculation bench's measured
    compile counters: every sweep point must have compiled its window
    exactly once."""
    out = []
    for sweep, rows in bench.items():
        if isinstance(rows, dict) and "spec_compiles" in rows:
            out.append({"what": f"compile count ({sweep})",
                        "predicted": 1,
                        "measured": rows["spec_compiles"],
                        "rel_err": _rel_err(1, rows["spec_compiles"])})
    return out


def run_honesty_checks(soi: dict | None = None, paged: dict | None = None,
                       selfspec: dict | None = None) -> list:
    """All predicted-vs-measured comparisons for the bench dicts given
    (the parsed bench files; none is read here). Returns dicts with
    ``rel_err``."""
    checks = []
    if soi is not None and "devloop_step_soi_aligned_s" in soi:
        checks.append(check_soi_bench(soi))
    if paged is not None:
        checks += check_paged_bench(paged)
    if selfspec is not None:
        checks += check_selfspec_bench(selfspec)
    return checks


def main(argv=None, benches: dict | None = None) -> int:
    """Print the plans of the matrix cells on :data:`H100`, and the
    honesty checks of ``benches`` (``{"soi": ..., "paged": ...,
    "selfspec": ...}``, parsed bench dicts; none by default)."""
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.plan")
    ap.add_argument("--cells", default=None,
                    help="comma-separated matrix cells (default: all)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    cells = args.cells.split(",") if args.cells else None
    plans = plan_matrix(cells)
    checks = run_honesty_checks(**(benches or {}))
    if args.json:
        print(json.dumps({"hardware": dataclasses.asdict(H100),
                          "plans": {n: p.to_dict() for n, p in plans.items()},
                          "honesty": checks}, indent=2))
        return 0
    print(f"== repro_torch.launch.plan @ {H100.name} "
          f"({H100.peak_flops / 1e12:.1f} TFLOP/s, "
          f"{H100.hbm_bw / 1e12:.2f} TB/s, "
          f"{H100.hbm_bytes / 2**30:.0f} GiB) ==")
    hdr = (f"{'cell':16s} {'tok/s':>12s} {'step p0':>10s} {'step off':>10s} "
           f"{'B/slot':>10s} {'max slots':>10s} {'programs':>8s}")
    print(hdr)
    for n, p in plans.items():
        print(f"{n:16s} {p.tok_s:12,.0f} {p.step_s_phase0 * 1e6:9.2f}u "
              f"{p.step_s_offphase * 1e6:9.2f}u "
              f"{p.state_bytes_per_slot:10,.0f} {p.max_slots:10,d} "
              f"{p.compile_count:8d}")
    if checks:
        print("\n-- honesty: prediction vs measured bench --")
        for c in checks:
            pred = c.get("predicted", c.get("predicted_tok_s"))
            meas = c.get("measured", c.get("measured_tok_s"))
            print(f"  {c['what']:38s} pred {pred:14,.2f}  "
                  f"meas {meas:14,.2f}  err {c['rel_err']:+.1%}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
