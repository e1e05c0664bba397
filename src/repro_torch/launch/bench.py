"""BENCH_*.json trajectory schema: lint + write helper (a copy of
``repro.launch.bench``, for the port's benches).

Every benchmark emits a ``BENCH_<name>.json`` at the repo root (the
port's: ``BENCH_torch_<name>.json``, never one of the reference's files);
the history of those files across PRs is the repo's performance
trajectory, and ``repro_torch.launch.plan``'s honesty checks read them
(parsed, as dicts) as the measured half of its predicted-vs-measured
comparisons. A malformed file (NaN from a
divide-by-zero, a nested blob some refactor left behind, a stray list)
used to corrupt that quietly — this module is the shared gate: benchmarks
write through :func:`write_bench`, and a tier-1 test validates every
checked-in file with :func:`validate_bench_file`.

The trajectory format, deliberately minimal so ``json.load`` + ``float()``
is a full reader:

* the document is a non-empty JSON object;
* each value is a finite scalar (bool / int / float — no NaN/inf, which
  ``json.dump`` happily writes and ``json.load`` happily reads) or a
  string label, OR one nested level of such scalars keyed by a sweep name
  (``BENCH_selfspec.json``'s ``stride2_k4`` style);
* keys are non-empty strings; no deeper nesting, no arrays.
"""

from __future__ import annotations

import json
import math
import pathlib


# Per-file required keys: trajectory files the trend tooling reads specific
# fields from declare them here; validate_bench checks membership by file
# name, so a refactor that renames (or forgets) a percentile field fails the
# bench run / tier-1 instead of silently breaking the trend reader.
REQUIRED_KEYS = {
    "BENCH_serving_trace.json": (
        "hit_rate", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
        "tok_s", "off_phase_by_occ", "off_phase_by_occ_aligned",
        "phase_coherent_rate_aligned"),
    # kernel-vs-ref timing rows: the trend reader compares the Pallas
    # hot-path implementations against the pure-JAX references, so a bench
    # regeneration that silently drops the kernel column must fail loudly
    "BENCH_paged_kv.json": (
        "wallclock_step_dense_s", "wallclock_step_paged_s",
        "wallclock_step_paged_kernel_s", "kernel_backend"),
    "BENCH_soi_lm.json": (
        "wallclock_step_soi_s", "wallclock_step_soi_kernel_s",
        "kernel_backend"),
}


def _scalar_error(key: str, v) -> str | None:
    if isinstance(v, bool) or isinstance(v, (int, str)):
        return None
    if isinstance(v, float):
        if math.isfinite(v):
            return None
        return f"{key}: non-finite float {v!r} (NaN/inf corrupts trajectories)"
    return (f"{key}: {type(v).__name__} is not a trajectory scalar "
            f"(bool/int/float/str)")


def validate_bench(data, name: str = "BENCH") -> list:
    """Schema errors (empty list = valid) for one parsed BENCH document."""
    errors = []
    if not isinstance(data, dict):
        return [f"{name}: top level must be a JSON object, "
                f"got {type(data).__name__}"]
    if not data:
        return [f"{name}: empty object — a bench that measured nothing"]
    for req in REQUIRED_KEYS.get(name, ()):
        if req not in data:
            errors.append(f"{name}: missing required key {req!r}")
    for key, v in data.items():
        if not isinstance(key, str) or not key:
            errors.append(f"{name}: non-string or empty key {key!r}")
            continue
        if isinstance(v, dict):
            if not v:
                errors.append(f"{name}.{key}: empty sweep group")
            for k2, v2 in v.items():
                if not isinstance(k2, str) or not k2:
                    errors.append(f"{name}.{key}: non-string key {k2!r}")
                    continue
                if isinstance(v2, dict):
                    errors.append(f"{name}.{key}.{k2}: nesting deeper than "
                                  f"one sweep level")
                    continue
                err = _scalar_error(f"{name}.{key}.{k2}", v2)
                if err:
                    errors.append(err)
            continue
        err = _scalar_error(f"{name}.{key}", v)
        if err:
            errors.append(err)
    return errors


def validate_bench_file(path) -> list:
    path = pathlib.Path(path)
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError) as e:
        return [f"{path.name}: unreadable ({e})"]
    return validate_bench(data, name=path.name)


def write_bench(rows: dict, path) -> None:
    """Validate-then-write: the emit path every benchmark should use.
    Raises ``ValueError`` (and writes nothing) on a schema violation, so a
    bad measurement fails the bench run instead of landing in git."""
    errors = validate_bench(rows, name=pathlib.Path(path).name)
    if errors:
        raise ValueError("refusing to write malformed bench file:\n  "
                         + "\n  ".join(errors))
    with open(path, "w") as fh:
        json.dump(rows, fh, indent=2)
        fh.write("\n")


def repo_bench_files(root) -> list:
    """Every checked-in trajectory file, sorted for stable test output."""
    return sorted(pathlib.Path(root).glob("BENCH_*.json"))
