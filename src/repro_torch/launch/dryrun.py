"""Multi-pod dry run: lay every (architecture x input shape x mesh) cell out
over a production mesh without a card or a process group (port of
``repro.launch.dryrun``).

For each cell: abstract-init the params (``FakeTensorMode`` — a 236B model
never allocates), map every parameter to its spec through the sharding
rules and the arch's knobs, and record ``n_params``, the train cells'
microbatch count, the sharding notes (each divisibility fallback), and the
bytes one device holds of the float32 params, of the AdamW state (train
cells) and of the batch (train and prefill) or the decode state (decode
cells). ``fits`` holds their sum against ``plan.H100``'s memory less its
reserve. ``--remat`` sets the cells' ``remat_policy`` (``full``, ``dots``,
``names`` or ``none``), as the reference's override does, and the record
carries it. Activations and workspace are not counted: the reference's
compile-derived fields (XLA's temp bytes, ``cost_analysis``, the HLO
collective bytes) have no counterpart here yet (ROADMAP.md).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

One JSON a cell under ``--out`` (default ``experiments/dryrun_torch``);
exits 1 if any cell errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.distributed.sharding import (ShardingRules, axes_size,
                                              per_device_bytes)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (AbstractMesh, data_axes_of,
                                     production_shape)
from repro_torch.launch.plan import H100

LM_ARCHS = list(configs.ARCHS)

# Per-arch production knobs, as the reference commits them: rows of batch
# per device per microbatch for train_4k (activation-memory control);
# seq_shard activations for every multi-GB-activation model; FSDP whenever
# params don't fit TP-only.
KNOBS = {
    "qwen3-1.7b": dict(rows=4),
    "mistral-large-123b": dict(rows=4, fsdp=True, seq_shard=True),
    "nemotron-4-15b": dict(rows=4, fsdp=True, seq_shard=True),
    "h2o-danube-1.8b": dict(rows=4),
    "recurrentgemma-9b": dict(rows=2, fsdp=True, seq_shard=True),
    "rwkv6-1.6b": dict(rows=4),
    "deepseek-v2-236b": dict(rows=2, fsdp=True, seq_shard=True),
    "olmoe-1b-7b": dict(rows=4),
    "paligemma-3b": dict(rows=4),
    "whisper-tiny": dict(rows=16),
}

# what one card holds for these: its memory less the planner's reserve
CARD_BYTES = H100.hbm_bytes * (1.0 - H100.hbm_reserve_frac)


def cell_runnable(cfg, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 500k dense KV is the quadratic "
                       "regime this shape excludes (DESIGN.md "
                       "§Arch-applicability)")
    return True, ""


def microbatches_for(global_batch: int, dp_size: int, rows: int) -> int:
    """The reference's rule: ``rows`` batch rows a device a microbatch,
    lowered until the microbatches divide the batch and each divides over
    the data axes."""
    mb = max(1, global_batch // (dp_size * rows))
    while global_batch % mb or (global_batch // mb) % dp_size:
        mb -= 1
    return mb


@functools.lru_cache(maxsize=None)
def _abstract_decode_state(cfg, shape_name):
    # one FakeTensorMode build for both meshes
    return S.abstract_decode_state(cfg, shape_name)[0]


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, soi=None,
             overrides: dict | None = None) -> dict:
    t0 = time.perf_counter()
    cfg = configs.get(arch, soi=soi)
    if overrides and overrides.get("remat"):
        cfg = dataclasses.replace(cfg, remat_policy=overrides["remat"])
    info = SHAPES[shape_name]
    mesh = AbstractMesh(production_shape(multi_pod))
    rec = {"arch": arch, "shape": shape_name, "mesh": repr(mesh),
           "kind": info["kind"], "soi": soi or "none",
           "remat_policy": cfg.remat_policy}
    ok, why = cell_runnable(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    knobs = dict(KNOBS.get(arch, {}))
    if overrides:
        knobs.update(overrides)
    dp_axes = data_axes_of(mesh)
    rules = ShardingRules(data_axes=dp_axes, fsdp=knobs.get("fsdp", False),
                          seq_shard=knobs.get("seq_shard", False))
    notes: list = []
    p_shapes, p_specs = S.param_specs(cfg, rules, mesh, notes)
    rec["n_params"] = sum(t.numel() for t in p_shapes.values())
    dp_size = axes_size(mesh, dp_axes)
    nbytes = {"params": per_device_bytes(p_shapes, p_specs, mesh)}
    if info["kind"] == "train":
        rec["microbatches"] = microbatches_for(
            info["global_batch"], dp_size, knobs.get("rows", 8))
        nbytes["opt"] = per_device_bytes(S.abstract_opt(p_shapes),
                                         S.opt_specs(p_specs), mesh)
    if info["kind"] in ("train", "prefill"):
        b_shapes, b_specs = S.batch_specs(cfg, shape_name, rules, mesh)
        nbytes["batch"] = per_device_bytes(b_shapes, b_specs, mesh)
    else:
        state = _abstract_decode_state(cfg, shape_name)
        nbytes["decode_state"] = per_device_bytes(
            state, S.decode_state_specs(state, rules, mesh), mesh)
    total = sum(nbytes.values())
    rec["per_device_bytes"] = dict(nbytes, total=total)
    rec["card_bytes"] = CARD_BYTES
    rec["fits"] = total <= CARD_BYTES
    rec["sharding_notes"] = sorted(set(notes))[:20]
    rec["timing"] = {"layout_s": round(time.perf_counter() - t0, 2)}
    rec["status"] = "ok"
    return rec


def _gb(x):
    return "-" if x is None else f"{x / 1e9:.2f}"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=LM_ARCHS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--soi", default=None, choices=[None, "pp", "fp"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--fsdp", action="store_true", default=None)
    ap.add_argument("--seq-shard", action="store_true", default=None)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--remat", default=None,
                    choices=["full", "dots", "names", "none"])
    args = ap.parse_args(argv)

    archs = LM_ARCHS if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    overrides = {k: v for k, v in (("fsdp", args.fsdp),
                                   ("seq_shard", args.seq_shard),
                                   ("rows", args.rows),
                                   ("remat", args.remat)) if v is not None}

    os.makedirs(args.out, exist_ok=True)
    results = []
    print(f"{'status':7s} {'cell':52s} {'params':>8s} {'opt':>8s} "
          f"{'batch':>8s} {'state':>8s} {'total':>8s}  GB a device "
          f"(fits: <= {CARD_BYTES / 1e9:.2f} GB of the H100's 80 GiB)")
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}_{shape}_{'multi' if multi else 'single'}" + (
                    f"_soi-{args.soi}" if args.soi else "")
                try:
                    rec = run_cell(arch, shape, multi, soi=args.soi,
                                   overrides=overrides or None)
                except Exception as e:  # a failed cell is a bug — record it
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi else "16x16",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                results.append(rec)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                b = rec.get("per_device_bytes", {})
                fits = ("" if "fits" not in rec else
                        "fits" if rec["fits"] else "DOES NOT FIT")
                print(f"{rec['status']:7s} {tag:52s} "
                      f"{_gb(b.get('params')):>8s} {_gb(b.get('opt')):>8s} "
                      f"{_gb(b.get('batch')):>8s} "
                      f"{_gb(b.get('decode_state')):>8s} "
                      f"{_gb(b.get('total')):>8s}  {fits}", flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    if n_err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
