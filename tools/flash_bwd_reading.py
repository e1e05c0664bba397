"""The bf16 ``flash_attention_bwd`` of this tree against an older tree's,
timed in one run at qwen3's shapes (H 16, Hkv 8, dh 128; B 8 x S 128
training, B 1 x S 1024 the prefill bucket, B 1 x S 4096 the Qwen3
pretraining length), on one CUDA card.

    python3 tools/flash_bwd_reading.py OLDER_CSRC

The ``flash_attention_bwd.cu`` of this tree's ``csrc`` and of
``OLDER_CSRC`` (another tree's ``src/repro_torch/kernels/csrc``) are
compiled together, each into its own library under
``build/flash_bwd_reading/``. Prints the card's name and power limit,
ptxas' registers and spills of each one's dh-128 bf16 kernels, then per
shape and source: rel max|Δ| of dq, dk, dv against
``ref.flash_attention_bwd`` (each <= 2e-2 of its largest, repeating bit
for bit), the device ms a call (torch.profiler, between
``chip_smoke.MARKERS`` spin kernels a side) read twice in turns (this,
older, older, this), the useful TFLOP/s, and SDPA's backward and the
bound beside them.
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
from repro_torch.kernels import ref                            # noqa: E402

OUT = ROOT / "build" / "flash_bwd_reading"
SHAPES = (("train", 8, 128), ("prefill bucket", 1, 1024),
          ("pretraining length", 1, 4096))
PARTS = ("delta_kernel", "dkdv_kernel", "dq_kernel")


def _build_both(older):
    """{"this" / "older": (C entry point, ptxas lines of its bf16
    kernels)}, both nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"this": _build.CSRC / "flash_attention_bwd.cu",
               "older": Path(older) / "flash_attention_bwd.cu"}
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(OUT / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        smoke.check(p.returncode == 0, f"nvcc {name} failed:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).repro_flash_attention_bwd
        sig = list(_build.SIGNATURES["repro_flash_attention_bwd"])
        # a tree from before d_v != d_qk takes one head dim (no DV)
        two_dims = "int DQK, int DV" in sources[name].read_text()
        if not two_dims:
            del sig[_DV_ARG]
        fn.argtypes = sig
        fn.restype = ctypes.c_int
        libs[name] = (_entry(fn, two_dims), _ptxas(log))
    return libs


# the position of DV among the C entry point's arguments
_DV_ARG = 16


def _entry(fn, two_dims):
    """The C entry point called with this tree's arguments (DV dropped
    for an older tree's)."""
    if two_dims:
        return fn
    return lambda *a: fn(*a[:_DV_ARG], *a[_DV_ARG + 1:])


def _ptxas(log):
    """'kernel: N registers, spill st/ld a/b B' for the dh-128 bf16
    kernels."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill st/ld {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "Li128E" in name and (
                "bfloat16" in name or "tensor_cores" in name):
            kind = next((p for p in PARTS if p in name), name)
            out.append(f"{kind} {m.group(1)} registers, {spill}")
            name, spill = None, ""
    return out


def _call(fn, q, k, v, o, do, lse):
    """One backward through ``fn`` (the C entry point), as the wrapper
    ``flash_attention.flash_attention_bwd`` makes it."""
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, hkv, dh,
            v.shape[-1], 0, 1,
            dh ** -0.5, _build.DTYPE_CODES["bfloat16"],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_bwd")
    return dq, dk, dv


def _sdpa_ms(sets):
    """SDPA's backward through autograd, K/V repeated to H heads (as
    ``chip_smoke._bwd_timing``)."""
    graphs = [(*smoke._sdpa(q, k, v, True), do.transpose(1, 2))
              for q, k, v, _o, do, _lse in sets]

    def run(i):
        out, ins, g = graphs[i]
        return torch.autograd.grad(out, ins, g, retain_graph=True)
    return smoke._device_ms(run, [(i,) for i in range(len(graphs))], 20,
                            markers=smoke.MARKERS)


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
    gen = torch.Generator(device=dev).manual_seed(25)
    libs = _build_both(args.older)
    for name, (_fn, lines) in libs.items():
        print(f"{name}: " + ("; ".join(lines) or "no bf16 dh-128 lines"))
    bf16 = torch.bfloat16
    for label, b, s in SHAPES:
        make, nbytes = smoke._bwd_inputs(b, s, bf16, dev, gen)
        sets = smoke._copies(make, nbytes)
        flops = 10.0 * b * 16 * 128 * (s * (s + 1) // 2)
        bound, by = smoke._bound(nbytes, flops, bf16)
        want = ref.flash_attention_bwd(*sets[0])
        for name, (fn, _l) in libs.items():
            got = _call(fn, *sets[0])
            again = _call(fn, *sets[0])
            rels = [float((g.float() - w.float()).abs().max()
                          / w.float().abs().max())
                    for g, w in zip(got, want)]
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            print(f"{label} ({b},{s},16/8,128) {name}: rel max|Δ| dq "
                  f"{rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e}, bit "
                  f"for bit {same}", flush=True)
            smoke.check(max(rels) <= smoke.TOL[bf16] and same,
                        f"{label} {name}: off the plain version")
        del want
        readings = {name: [] for name in libs}
        for name in ("this", "older", "older", "this"):
            parts = {}
            ms = smoke._device_ms(
                lambda *a, fn=libs[name][0]: _call(fn, *a), sets, 20,
                by_name=parts, bound_ms=bound, markers=smoke.MARKERS,
                each=("dkdv_kernel", "dq_kernel"))
            split = {p: sum(t for n, t in parts.items() if p in n)
                     for p in PARTS}
            readings[name].append((ms, split))
        lib_ms = _sdpa_ms(sets[:8])
        for name, reads in readings.items():
            ms = [r[0] for r in reads]
            split = " / ".join(f"{reads[0][1][p]:.4f}" for p in PARTS)
            print(f"{label} ({b},{s}) {name}: {ms[0]:.4f} / {ms[1]:.4f} ms "
                  f"(delta / dK-dV / dQ {split}), "
                  f"{flops / min(ms) / 1e9:.1f} TFLOP/s useful; SDPA "
                  f"backward {lib_ms:.4f}; bound {bound:.5f} ({by})",
                  flush=True)
        del sets
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
