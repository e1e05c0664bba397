"""Build and load the hand-written CUDA kernels.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` process per source, all started together), linked into
``build/repro_torch/libkernels-<hash>.so`` at the repository root and loaded
with ``ctypes``. The sources expose a plain C interface and include no
PyTorch header, so a build takes seconds, not minutes. The hash covers the
sources, headers and flags: an edited kernel rebuilds, an unchanged one
loads the existing library. A failed build raises with nvcc's output.

Nothing here runs at import time; the CPU path never builds anything.

``metered`` marks each kernel wrapper for the cost meter
(``repro_torch.analysis.meter``): with no meter active it costs the wrapper
one global read; under a meter the call is priced by ``kernels/costs.py``
from its operands' shapes, on every device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (see the ``extern "C"`` functions)
SIGNATURES = {
    "repro_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                              _I, _P],
    "repro_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _I, _P],
    "repro_chunk_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                              _I, _P],
    "repro_paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _F,
                                     _I, _I, _I, _P],
    "repro_copy_pages": [_P, _I, _I, _P],
    "repro_mla_chunk_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "repro_paged_mla_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _I, _I, _I, _I, _I, _I, _F,
                                         _I, _I, _I, _P],
    "repro_lru_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    "repro_lru_scan_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P],
    "repro_stmc_conv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P],
}
# dtype codes of csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float | None      # None: the library was already built
    log: str                   # nvcc / ptxas output (-Xptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libkernels-{source_hash()}.so"


def build() -> BuildInfo:
    """Compile every source in parallel and link the shared library (an
    existing library for the same hash is reused)."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(out, None, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, cmd, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode:
                failed.append(f"$ {' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp_lib), *(str(o) for _s, o, _c, _p in procs)]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                               f"{link.stdout}")
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(tmp_lib, out)       # atomic: a reader never sees half
    return BuildInfo(out, time.perf_counter() - t0, log)


@functools.lru_cache(maxsize=None)
def _load() -> tuple[ctypes.CDLL, BuildInfo]:
    info = build()
    lib = ctypes.CDLL(str(info.path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, info


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return _load()[0]


def build_info() -> BuildInfo:
    """How the loaded library came to be: path, build seconds, ptxas log."""
    return _load()[1]


# the active cost meter (``analysis.meter.Meter``), or None
METER = None


def metered(name: str):
    """Decorate the kernel wrapper ``name`` (its ``kernels/costs.py`` key):
    under an active meter the call goes through ``METER.kernel_call``,
    which runs it and prices it; otherwise the wrapper runs as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if METER is None:
                return fn(*args, **kwargs)
            return METER.kernel_call(name, fn, args, kwargs)
        return wrapper
    return deco


def needs_grad(*tensors) -> bool:
    """Grad mode is on and some input (None aside) requires grad: a host
    check of flags, no sync, nothing a captured graph sees."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``name``'s CUDA
    kernel, which has no backward (only ``flash_attention`` and
    ``lru_scan`` have one)."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward; call it under "
            f"torch.no_grad() (a backward is queued in ROADMAP.md)")


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")
