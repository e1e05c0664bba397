"""The forward ``lru_scan`` of this tree against an older tree's, timed in
one run at recurrentgemma's prefill shapes (width 4096: S 2040 outer and
1020 middle at B 1, f32 and bf16; S 2040 at B 4), on one CUDA card, each
at the plan ``lru_plan`` gives it.

    python3 tools/lru_feed_reading.py OLDER_CSRC

The ``lru_scan.cu`` of this tree's ``csrc`` and of ``OLDER_CSRC`` (another
tree's ``src/repro_torch/kernels/csrc``, e.g. the parent's from ``mkdir -p
build/parent_csrc && git archive HEAD src/repro_torch/kernels/csrc | tar
-x -C build/parent_csrc --strip-components=4``) are compiled together,
each into its own library under ``build/lru_feed_reading/``. Prints the
card's name and power limit, ptxas' registers of each one's ring kernels,
then per shape whether both equal the plain version bit for bit and the
device ms a call of each (torch.profiler, between ``chip_smoke.MARKERS``
spin kernels a side) read in turns: this, older, older, this, this, older.
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke                                     # noqa: E402
from repro_torch.kernels import _build                         # noqa: E402
from repro_torch.kernels import lru_scan as LS                 # noqa: E402
from repro_torch.kernels import ref                            # noqa: E402

OUT = ROOT / "build" / "lru_feed_reading"
# (label, B, S, dtype)
SHAPES = (("outer", 1, 2040, torch.float32), ("outer", 1, 2040,
                                              torch.bfloat16),
          ("middle", 1, 1020, torch.float32), ("B 4", 4, 2040,
                                               torch.float32))
ORDER = ("this", "older", "older", "this", "this", "older")


def _build_both(older):
    """{"this" / "older": (C entry point, ptxas lines of its ring
    kernels)}, both nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"this": _build.CSRC / "lru_scan.cu",
               "older": Path(older) / "lru_scan.cu"}
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(OUT / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        smoke.check(p.returncode == 0, f"nvcc {name} failed:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).repro_lru_scan
        fn.argtypes = _build.SIGNATURES["repro_lru_scan"]
        fn.restype = ctypes.c_int
        libs[name] = (fn, _ptxas(log))
    return libs


def _ptxas(log):
    """'registers' lines of the forward's ring kernels (not the edge
    path's, not the backward's)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "15lru_scan_kernel" in name and "Lb0E" in name:
            out.append(f"{'bf16' if 'bfloat16' in name else 'f32'} "
                       f"{m.group(1)} registers")
            name = None
    return out


def _call(fn, a, x):
    """One launch through ``fn`` (the C entry point) at the wrapper's
    plan, as ``lru_scan._launch`` makes it."""
    b, s, d = x.shape
    plan = LS.launch_plan(a, x)
    h = torch.empty_like(x)
    rc = fn(a.data_ptr(), x.data_ptr(), None, h.data_ptr(), b, s, d,
            plan.warps, plan.stages, plan.steps, int(plan.edge),
            _build.DTYPE_CODES["bfloat16" if x.dtype == torch.bfloat16
                               else "float32"],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "lru_scan")
    return h


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("older", help="another tree's csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20)
    libs = _build_both(args.older)
    for name, (_fn, lines) in libs.items():
        print(f"{name}: " + "; ".join(lines))
    for label, b, s, dt in SHAPES:
        d = 4096

        def make():
            a = (torch.rand((b, s, d), generator=gen, device=dev) * 0.89
                 + 0.1).to(dt)
            x = torch.randn((b, s, d), generator=gen, device=dev).to(dt)
            return a, x
        esz = torch.finfo(dt).bits // 8
        nbytes = 3 * b * s * d * esz
        sets = smoke._copies(make, nbytes)
        bound, by = smoke._bound(nbytes, 2.0 * b * s * d, torch.float32)
        want = ref.lru_scan(*sets[0])[0]
        for name, (fn, _l) in libs.items():
            got = _call(fn, *sets[0])
            smoke.check(torch.equal(got, want),
                        f"{label} {name}: not the plain version bit for bit")
        readings = {name: [] for name in libs}
        for name in ORDER:
            readings[name].append(smoke._device_ms(
                lambda *t, fn=libs[name][0]: _call(fn, *t), sets, 50,
                bound_ms=bound, markers=smoke.MARKERS,
                each=("lru_scan_kernel",)))
        plan = LS.launch_plan(*sets[0])
        for name, ms in readings.items():
            print(f"{label} ({b},{s},{d}) {str(dt)[6:]} {name}: "
                  + " / ".join(f"{m:.4f}" for m in ms)
                  + f" ms (plan: {plan.warps} a block, {plan.stages} "
                  f"stages of {plan.steps}); bound {bound:.5f} ({by}); "
                  f"bit for bit the plain version", flush=True)
        del sets
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
