"""Host-sync detector, runtime half (SYNC002) — port of
``repro.analysis.runtime``.

Cross-checks the static AST pass by actually running the scripted traffic
with a tripwire armed around the decode loop:

* on the card, ``torch.cuda.set_sync_debug_mode("error")``: any CUDA call
  that synchronizes the host with the device (``.item()``, a copy to
  pageable host memory, ``nonzero``, ...) raises inside the loop. A
  ``contracts.sanctioned_drain`` (the explicit batched drain ``host_get``
  makes) suspends the mode for its own transfer;
* on the CPU that mode is vacuous (nothing is on a device), so a
  ``TorchDispatchMode`` tripwire records every ``aten._local_scalar_dense``
  (``.item()``, ``float``/``int``/``bool`` of a tensor) and every copy from
  a CUDA tensor to the host, with the source line that triggered it; any
  record NOT issued under ``sanctioned_drain`` is a finding. This is the
  counterpart of the reference's ``ArrayImpl._value`` hook.

Known hole, documented rather than papered over: ``.numpy()`` and
``.tolist()`` of a CPU tensor read its memory without dispatching an op,
so the CPU tripwire cannot see them — those are exactly what the static
AST pass catches, which is why the two halves ship together.
"""

from __future__ import annotations

import contextlib
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import targets as T
from repro_torch.analysis.report import Finding
from repro_torch.engine import contracts

aten = torch.ops.aten


def _caller_frame():
    """First stack frame outside torch internals and this package's
    analysis/contract plumbing."""
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if ("/torch/" in fn or "runtime.py" in fn
                or "contracts.py" in fn):
            continue
        return f"{fn.split('/site-packages/')[-1]}:{frame.lineno}"
    return "<unknown>"


def _to_host(func, args, kwargs) -> bool:
    """A copy from a CUDA tensor to the host."""
    if func.overloadpacket is aten._to_copy:
        src = args[0]
        dev = kwargs.get("device")
        return (isinstance(src, torch.Tensor) and src.is_cuda
                and dev is not None and torch.device(dev).type == "cpu")
    if func.overloadpacket is aten.copy_:
        dst, src = args[0], args[1]
        return src.is_cuda and not dst.is_cuda
    return False


class _Tripwire(TorchDispatchMode):
    def __init__(self, records: list):
        super().__init__()
        self.records = records

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not contracts.in_sanctioned_drain() and (
                func.overloadpacket is aten._local_scalar_dense
                or _to_host(func, args, kwargs)):
            self.records.append(_caller_frame())
        return func(*args, **kwargs)


@contextlib.contextmanager
def sync_monitor(records: list, device):
    """Arm the tripwire for ``device``: on the card the sync debug mode
    raises at an unsanctioned sync; on the CPU every unsanctioned host
    read is appended to ``records``."""
    if torch.device(device).type == "cuda":
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield records
        finally:
            torch.cuda.set_sync_debug_mode(old)
    else:
        with _Tripwire(records):
            yield records


def run(target) -> list:
    engine, params = target.engine, target.params
    records: list = []
    findings = []

    # prefill/insert are allowed to sync (once per request, off the decode
    # clock) — arm the tripwire around the generate loop only
    ds = engine.init_decode_state(params)
    toks = T.prompts(target, seed=11)
    for slot in range(min(engine.max_concurrent_decodes, len(toks))):
        ds = engine.insert(engine.prefill(params, toks[slot]), ds, slot)

    pending = None
    try:
        with sync_monitor(records, engine.device):
            for _ in range(3):
                ds, res = engine.generate(params, ds)
                if pending is not None:
                    pending.convert_to_numpy()
                pending = res
    except RuntimeError as e:
        findings.append(Finding(
            "hostsync", "SYNC002", f"{target.name}:generate",
            f"sync tripwire fired inside the decode loop: {e!r}"))
    if pending is not None:
        pending.convert_to_numpy()

    for where in sorted(set(records)):
        findings.append(Finding(
            "hostsync", "SYNC002", f"{target.name}:{where}",
            f"unsanctioned host read inside the decode loop "
            f"({records.count(where)}x) — route it through the batched "
            f"drain (contracts.host_get) or move it off the step path"))
    return findings
