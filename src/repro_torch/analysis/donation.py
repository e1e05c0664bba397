"""In-place state analyzer (DON0xx) — port of ``repro.analysis.donation``.

The reference donates its decode state to each compiled step so XLA
updates the caches in place. The port's counterpart is state written in
place: a captured CUDA graph holds raw pointers, so a step that rebinds a
state leaf would leave every later replay reading stale storage (or copy
the decode state every step). Three layers of checking per
``GraphEntry``:

* **declaration** — an entry served by a ``CheckedGraph`` must list its
  ``state_args`` among the graph's ``state_argnums`` (DON001), and any
  other argument holding large buffers must be state or explicitly
  annotated ``readonly_ok`` with a reason (DON001);
* **execution** — the entry runs once, eagerly, under ``CheckedGraph``'s
  donation contract: every state leaf of at least ``BIG_BYTES`` must come
  back in its own storage (same ``data_ptr``, shape and dtype). The
  contract's ``DroppedDonationError`` — the reference's name for the
  broken contract — is reported as DON002, the reference's code for a
  donation XLA dropped;
* **runtime** — after real traffic, every leaf of the engine's live
  decode state of at least ``BIG_BYTES`` must still be the storage
  ``init_decode_state`` allocated: a rebound leaf means some host-side
  code replaced state a captured graph reads (DON003).
"""

from __future__ import annotations

from repro_torch.analysis import targets as T
from repro_torch.analysis.meter import tensors_of
from repro_torch.analysis.report import Finding
from repro_torch.engine.contracts import (BIG_BYTES, CheckedGraph,
                                          DroppedDonationError,
                                          state_leaves)


def _big(tree) -> list:
    return [t for t in tensors_of(tree) if t.numel() * t.element_size()
            >= BIG_BYTES]


def as_step(entry):
    """``entry.fn`` returning its carried state first, as ``CheckedGraph``
    wants it: ``(new_state, *rest)``."""
    out_index = entry.carry[1] if entry.carry is not None else 0

    def step(*args):
        out = entry.fn(*args)
        if out_index is None:
            return (out,)
        out = tuple(out)
        return (out[out_index],) + out[:out_index] + out[out_index + 1:]
    return step


def check_entry(target_name: str, entry) -> list:
    findings = []
    where = f"{target_name}:{entry.name}"
    if entry.graph is not None:
        for argnum in entry.state_args:
            if argnum not in entry.graph.state_argnums:
                findings.append(Finding(
                    "donation", "DON001", where,
                    f"state argument {argnum} is not among the graph's "
                    f"state_argnums: its leaves are not checked before a "
                    f"replay, so a rebound one would be read stale"))
    for argnum, arg in enumerate(entry.args):
        if (argnum in entry.state_args or argnum in entry.readonly_ok
                or argnum in entry.static_args):
            continue
        big = _big(arg)
        if big:
            findings.append(Finding(
                "donation", "DON001", f"{where}:arg{argnum}",
                f"{len(big)} buffer(s) >= {BIG_BYTES}B (max "
                f"{max(t.numel() * t.element_size() for t in big)}B) "
                f"neither state nor readonly_ok — write them in place as "
                f"state or declare why they must outlive the call"))
    if not entry.state_args:
        return findings
    checked = CheckedGraph(as_step(entry), state_argnums=entry.state_args,
                           static_argnums=entry.static_args,
                           name=entry.name)
    try:
        checked._run_checked(entry.args)
    except DroppedDonationError as e:
        findings.append(Finding("donation", "DON002", where, str(e)))
    except Exception as e:      # failing to run at all is a finding
        findings.append(Finding(
            "donation", "DON002", where,
            f"entry failed to run with example args: {e!r}"))
    return findings


def check_runtime(target) -> list:
    """Drive real traffic, then audit the live state's storage (DON003)."""
    engine = target.engine
    fresh = {}
    orig_init = engine.init_decode_state

    def recording_init(params):
        ds = orig_init(params)
        fresh.clear()
        fresh.update({label: (t, t.data_ptr())
                      for label, t in state_leaves(ds)})
        return ds

    engine.init_decode_state = recording_init
    try:
        T.drive_traffic(target, drain=lambda res: res.convert_to_numpy())
    finally:
        del engine.init_decode_state
    live = dict(state_leaves(engine._live))
    moved = sorted(label for label, (t, ptr) in fresh.items()
                   if t.numel() * t.element_size() >= BIG_BYTES
                   and (live.get(label) is not t
                        or live[label].data_ptr() != ptr))
    if moved or set(live) != set(fresh):
        return [Finding(
            "donation", "DON003", f"{target.name}:live_decode_state",
            f"{len(moved)} large leaves of the LIVE decode state are not "
            f"the storage init_decode_state allocated (first: "
            f"{(moved or ['<leaf set changed>'])[0]}) — host code rebound "
            f"state that the captured graphs read in place")]
    return []


def run(target, entries=None) -> list:
    entries = (target.engine.analysis_entries(target.params)
               if entries is None else entries)
    findings = []
    for entry in entries:
        findings.extend(check_entry(target.name, entry))
    findings.extend(check_runtime(target))
    return findings
