"""Hot-path contracts of the serving engine (port of
``repro.engine.contracts``).

The engine's speed rests on invariants the type system cannot see:

* **one program a step over state updated in place** — the reference
  compiles each hot-path state transition into one XLA program that
  donates the decode state (``checked_jit``). The port's counterpart is
  ``CheckedGraph``: on the card it captures the step once as a CUDA graph
  and replays it, over state tensors the step writes in place. A graph
  holds raw pointers, so a state leaf that a step (or its caller) rebinds
  would be read stale by every later replay. ``CheckedGraph`` turns that
  into a ``DroppedDonationError`` (the reference's name for the same
  broken contract), at the first call for a step that rebinds a large
  leaf and before any replay for a caller that rebinds one.
* **one sanctioned drain a step** — the only device->host transfer a
  serving loop makes is the batched token drain, ``host_get``.
  ``drain_count`` counts them.

``GraphEntry`` describes one engine entry for ``repro_torch.analysis``
(the counterpart of ``JitEntry``); ``SOIEngine.analysis_entries`` returns
them.

This module imports ``torch`` only.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.kernels import ops

# a state leaf this large must come back in its own storage: the
# reference's ``BIG_BYTES`` (``repro/analysis/donation.py``), below which
# its donation analysis ignores a leaf
BIG_BYTES = 16 * 1024


class DroppedDonationError(RuntimeError):
    """A state leaf of at least ``BIG_BYTES`` did not come back in its own
    storage (the step rebound it), or a caller rebound a state leaf that a
    captured graph writes. Either way a replay would work on stale
    pointers (or copy the decode state every step), so the engine refuses
    to run rather than degrade."""


# Entered (via ``sanctioned_drain``) while the engine makes its one
# sanctioned device->host drain; a conversion outside such a window is a
# host sync the serving loop did not mean to make.
_SANCTIONED_DEPTH = 0
# Sanctioned-drain entries since process start: a loop draining N steps
# shows ~N (more means something else also syncs through host_get).
_DRAIN_CALLS = 0


def _suspend_guard():
    """Turn off a sync debug mode (``torch.cuda.set_sync_debug_mode``) that
    a monitor armed on the card: a sanctioned drain, and a graph's one-time
    capture, sync by design. Returns the mode to restore, or None when
    there is none to suspend."""
    if not torch.cuda.is_initialized():
        return None
    mode = torch.cuda.get_sync_debug_mode()
    if not mode:
        return None
    torch.cuda.set_sync_debug_mode(0)
    return mode


def _restore_guard(mode) -> None:
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)


class sanctioned_drain:
    """Context marking an intentional, batched device->host transfer."""

    def __enter__(self):
        global _SANCTIONED_DEPTH, _DRAIN_CALLS
        _SANCTIONED_DEPTH += 1
        _DRAIN_CALLS += 1
        self._sync_mode = _suspend_guard()
        return self

    def __exit__(self, *exc):
        global _SANCTIONED_DEPTH
        _SANCTIONED_DEPTH -= 1
        _restore_guard(self._sync_mode)
        return False


def in_sanctioned_drain() -> bool:
    return _SANCTIONED_DEPTH > 0


def drain_count() -> int:
    """Sanctioned-drain entries since process start (monotonic; compare
    deltas across a serving session)."""
    return _DRAIN_CALLS


def host_copy_async(x: torch.Tensor):
    """Start the copy of the CUDA tensor ``x`` into fresh pinned host
    memory, on the current stream, without waiting: returns ``(host,
    event)``, the event recorded right behind the copy. ``host_get(host,
    ready=event)`` later drains it."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def host_get(tree, *, ready=None):
    """The engine's sanctioned device->host drain: a tensor or a tuple of
    tensors (None entries pass through) as numpy arrays, in ONE batched
    transfer. CUDA tensors are copied into pinned memory behind one event,
    which is waited for once; host tensors are viewed as they are, after
    ``ready`` (the event of a copy started by ``host_copy_async``), if
    given, has completed."""
    single = not isinstance(tree, (tuple, list))
    leaves = (tree,) if single else tuple(tree)
    with sanctioned_drain():
        if ready is not None:
            ready.synchronize()
        hosts, pending = [], None
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                pending = True
                x = host
            hosts.append(x)
        if pending:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        out = tuple(x.numpy() if isinstance(x, torch.Tensor) else x
                    for x in hosts)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# CheckedGraph: one CUDA graph per static branch over in-place state
# ---------------------------------------------------------------------------

def _tensors(obj, out: list):
    """The tensors of a state tree (dicts, lists, tuples; anything else
    that is not a tensor is skipped), in ``_steps`` order, without paths:
    the replay check's fast walk."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    return out


def _first_tensor(obj):
    """The first tensor of a state tree in ``_tensors`` order, or None."""
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, (dict, list, tuple)):
        for v in (obj.values() if isinstance(obj, dict) else obj):
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _set_path(root, steps: list, value):
    """Rebind the leaf at ``steps`` (keys / indices from the root) of a
    state tree to ``value``."""
    node = root
    for s in steps[:-1]:
        node = node[s]
    node[steps[-1]] = value


def _steps(obj, out: list, prefix=()):
    """``(key path, tensor)`` of every tensor of a state tree: the keys and
    indices that reach it, for ``_set_path``."""
    if isinstance(obj, torch.Tensor):
        out.append((list(prefix), obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _steps(v, out, prefix + (k,))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _steps(v, out, prefix + (i,))
    return out


def _label(steps) -> str:
    return "".join(f"[{s!r}]" for s in steps)


def state_leaves(tree) -> list:
    """``(label, tensor)`` of every tensor of a state tree, the label its
    keys and indices (``"['model']['pre'][0]['k']"``)."""
    return [(_label(steps), t) for steps, t in _steps(tree, [])]


def _module_slots(mod: torch.nn.Module) -> list:
    """``(owner dict, key, tensor)`` of every parameter and buffer of a
    module: where a replay check finds each one again without walking the
    module tree."""
    out = []
    for sub in mod.modules():
        for store in (sub._parameters, sub._buffers):
            for k, t in store.items():
                if t is not None:
                    out.append((store, k, t))
    return out


class _Captured:
    """One captured graph: its inputs as captured (identity and pointer),
    its static outputs, the kernel launches one replay makes, and what its
    capture cost."""

    def __init__(self):
        self.graph = None
        self.out = None
        self.state = []         # (tensor, data_ptr) of every state leaf
        self.inputs = []        # (arg index, [(tensor, data_ptr)]): others
        self.modules = []       # (arg index, module, [(store, key, t, ptr)])
        self.launches = {}
        self.copy_back_bytes = 0
        self.capture_s = 0.0
        self.pool_bytes = 0


class CheckedGraph:
    """``fn`` run as one CUDA graph per static branch, over state that
    ``fn`` updates in place (the counterpart of ``CheckedJit``, whose
    ``DroppedDonationError`` it raises and whose attribute passthrough it
    replaces with ``stats()``, ``captures`` and ``replays``).

    ``fn(*args)`` returns ``(new_state_0, ..., new_state_k, *outputs)``:
    one new state per position of ``state_argnums``, in that order, with
    the same leaves (dicts, lists, tuples of tensors) as the state it was
    given. The donation contract: every state leaf of at least
    ``BIG_BYTES`` comes back in its input's storage (the same
    ``data_ptr``), or ``DroppedDonationError`` names it. A smaller leaf the
    step rebinds (a clock, a conv window) is copied back into its input
    tensor, which takes its place in the returned state; inside a captured
    graph that copy is a node of the graph. ``static_argnums`` are Python
    values (hashable) that select the branch: each value gets its own
    graph, all of them in one memory pool.

    On a CUDA device the first call of a branch runs ``fn`` eagerly on a
    side stream — a real step whose result is returned — and then captures
    it (``torch.cuda.graph``); every later call replays the graph and
    returns its static outputs, which the next replay of any branch may
    overwrite: callers copy out what they keep. Before a replay the
    wrapper checks that every tensor argument — state leaves, other
    tensors, and the parameters and buffers of ``nn.Module`` arguments —
    is the tensor it captured, at the same ``data_ptr``; a rebound state
    leaf raises ``DroppedDonationError``, any other rebound input
    ``ValueError``. A failed capture raises; nothing retries eagerly.

    The kernel wrappers count their launches on the host
    (``kernels/ops.py``), which a replay does not reach: the launches a
    capture records are taken back once it ends and added again at every
    replay, so ``ops.launch_counts()`` counts what the card ran.

    On the CPU ``fn`` runs eagerly on every call, under the same donation
    contract: that is dispatch by device, as the kernel wrappers do.
    """

    def __init__(self, fn, *, state_argnums=(), static_argnums=(),
                 name: str | None = None):
        self._fn = fn
        self.state_argnums = ((state_argnums,) if isinstance(state_argnums,
                                                             int)
                              else tuple(state_argnums))
        self.static_argnums = ((static_argnums,)
                               if isinstance(static_argnums, int)
                               else tuple(static_argnums))
        self.name = name or getattr(fn, "__name__", "step")
        self._graphs: dict = {}
        self._eager_keys: set = set()
        self._pool = None
        self._stream = None
        self.captures = 0
        self.replays = 0

    # -- the donation contract -------------------------------------------

    def _run_checked(self, args):
        """``fn(*args)`` with the donation contract applied to its new
        states; returns fn's result with the copied-back leaves in place,
        and the bytes copied back."""
        before = [_steps(args[i], []) for i in self.state_argnums]
        out = self._fn(*args)
        n = len(self.state_argnums)
        if not isinstance(out, tuple) or len(out) < n:
            raise TypeError(f"{self.name}: fn must return its {n} new "
                            f"state(s) first, got {type(out).__name__}")
        copied = 0
        for j, (argnum, old) in enumerate(zip(self.state_argnums, before)):
            new_state = out[j]
            new = _steps(new_state, [])
            if [p for p, _ in new] != [p for p, _ in old]:
                raise DroppedDonationError(
                    f"{self.name}: the state of argument {argnum} came back "
                    f"with other leaves ({len(new)} against {len(old)}): "
                    f"a captured graph needs the state it was given")
            for (steps, t_old), (_, t_new) in zip(old, new):
                if t_new.data_ptr() == t_old.data_ptr():
                    continue
                label = _label(steps)
                if t_old.nbytes >= BIG_BYTES:
                    raise DroppedDonationError(
                        f"{self.name}: state leaf {label} of argument "
                        f"{argnum} ({tuple(t_old.shape)}, {t_old.nbytes} "
                        f"bytes >= {BIG_BYTES}) did not come back in its "
                        f"own storage: the step must write it in place")
                if t_new.shape != t_old.shape or t_new.dtype != t_old.dtype:
                    raise DroppedDonationError(
                        f"{self.name}: state leaf {label} of argument "
                        f"{argnum} came back as {tuple(t_new.shape)} "
                        f"{t_new.dtype}, not {tuple(t_old.shape)} "
                        f"{t_old.dtype}")
                t_old.copy_(t_new)
                copied += t_old.nbytes
                _set_path(new_state, steps, t_old)
        return out, copied

    # -- calls ------------------------------------------------------------

    def __call__(self, *args):
        dev = self._device(args)
        key = tuple(args[i] for i in self.static_argnums)
        if dev.type != "cuda":
            self._eager_keys.add(key)
            return self._run_checked(args)[0]
        cap = self._graphs.get(key)
        if cap is None:
            # a branch's first step captures once: its syncs are not the
            # steady state a sync monitor watches
            mode = _suspend_guard()
            try:
                return self._first(key, args, dev)
            finally:
                _restore_guard(mode)
        self._check(cap, args)
        cap.graph.replay()
        ops.add_launch_counts(cap.launches)
        self.replays += 1
        return cap.out

    def _device(self, args) -> torch.device:
        for i in self.state_argnums:
            t = _first_tensor(args[i])
            if t is not None:
                return t.device
        raise ValueError(f"{self.name}: the state arguments hold no tensor")

    def _first(self, key, args, dev):
        """The branch's first call: one eager step on the side stream, then
        the capture."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out, _ = self._run_checked(args)
        cur.wait_stream(self._stream)

        cap = _Captured()
        cap.graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(cap.graph, pool=self._pool,
                                  stream=self._stream):
                cap.out, cap.copy_back_bytes = self._run_checked(args)
        finally:
            after = ops.launch_counts()
            cap.launches = {k: after[k] - counts[k] for k in after
                            if after[k] != counts[k]}
            # the capture ran nothing: take its launches back
            ops.add_launch_counts({k: -n for k, n in cap.launches.items()})
        cap.capture_s = time.perf_counter() - t0
        cap.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._record_inputs(cap, args)
        self._graphs[key] = cap
        self.captures += 1
        return out

    def _record_inputs(self, cap: _Captured, args):
        for i, a in enumerate(args):
            if i in self.static_argnums:
                continue
            if i in self.state_argnums:
                cap.state += [(t, t.data_ptr()) for t in _tensors(a, [])]
            elif isinstance(a, torch.nn.Module):
                cap.modules.append((i, a, [(store, k, t, t.data_ptr())
                                           for store, k, t in
                                           _module_slots(a)]))
            else:
                cap.inputs.append((i, [(t, t.data_ptr())
                                       for t in _tensors(a, [])]))

    def _check(self, cap: _Captured, args):
        """Every tensor argument is the one captured, at its pointer."""
        state = []
        for i in self.state_argnums:
            _tensors(args[i], state)
        ok = len(state) == len(cap.state) and all(
            t is c and t.data_ptr() == p
            for t, (c, p) in zip(state, cap.state))
        if not ok:
            raise DroppedDonationError(
                f"{self.name}: {self._first_mismatch(cap, args)}; the "
                f"captured graph writes the tensors it was captured with, "
                f"so a rebound state leaf would be read stale")
        for i, mod, slots in cap.modules:
            if args[i] is not mod or not all(
                    store.get(k) is t and t.data_ptr() == p
                    for store, k, t, p in slots):
                raise ValueError(
                    f"{self.name}: argument {i} is not the module the graph "
                    f"was captured with, or one of its parameters or "
                    f"buffers moved (cast or rebound); a replay would read "
                    f"the old weights")
        for i, want in cap.inputs:
            got = _tensors(args[i], [])
            if len(got) != len(want) or not all(
                    g is t and g.data_ptr() == p
                    for g, (t, p) in zip(got, want)):
                raise ValueError(
                    f"{self.name}: tensor argument {i} is not the one the "
                    f"graph was captured with; copy new values into it "
                    f"instead")

    def _first_mismatch(self, cap: _Captured, args) -> str:
        named = []
        for i in self.state_argnums:
            named += [(i, p, t) for p, t in state_leaves(args[i])]
        for (i, path, t), (c, p) in zip(named, cap.state):
            if t is not c or t.data_ptr() != p:
                return (f"state leaf {path} of argument {i} is not the "
                        f"tensor the graph was captured with")
        return (f"the state holds {len(named)} tensors, the graph was "
                f"captured with {len(cap.state)}")

    # -- bookkeeping ------------------------------------------------------

    def reset(self):
        """Drop every captured graph and the pool (the state they were
        captured over is gone)."""
        self._graphs = {}
        self._eager_keys = set()
        self._pool = None
        self._stream = None

    def keys(self) -> set:
        """The branch keys run since the last ``reset``: on the card one
        capture each, on the CPU the graphs the card would capture."""
        return set(self._graphs) | self._eager_keys

    def stats(self) -> dict:
        """Per branch: capture seconds, pool bytes reserved by the capture,
        bytes copied back a replay, kernel launches a replay."""
        return {key: {"capture_s": c.capture_s, "pool_bytes": c.pool_bytes,
                      "copy_back_bytes": c.copy_back_bytes,
                      "launches": dict(c.launches)}
                for key, c in self._graphs.items()}


def checked_graph(fn=None, *, state_argnums=(), static_argnums=(),
                  name: str | None = None):
    """``CheckedGraph(fn, ...)``; usable as a decorator."""
    if fn is None:
        return lambda f: CheckedGraph(f, state_argnums=state_argnums,
                                      static_argnums=static_argnums,
                                      name=name)
    return CheckedGraph(fn, state_argnums=state_argnums,
                        static_argnums=static_argnums, name=name)


@dataclasses.dataclass(frozen=True)
class GraphEntry:
    """One engine entry point, described for ``repro_torch.analysis`` (the
    counterpart of ``repro.engine.contracts.JitEntry``).

    ``fn`` is the entry's eager callable: the analysis passes run it once
    on ``args`` (the meter must reach the kernel wrappers, which a
    replayed graph never does). ``graph`` is the ``CheckedGraph`` that
    serves ``fn`` on the card, or None for an entry that runs eagerly
    everywhere (prefill, insert, release). ``args`` are example arguments
    shaped like live traffic: the decode state is a real freshly
    initialized one, so running an entry writes that state (in place, as
    serving does). ``state_args`` are the positions whose leaves the step
    writes in place — the graph's ``state_argnums``, which the reference
    spells ``donate``/``state_args``: every leaf of at least ``BIG_BYTES``
    must come back in its own storage. ``static_args`` are positions that
    hold host values (Python ints, bools, tuples): a graph keys its
    branches on them, an eager entry reads them on the host.
    ``readonly_ok`` maps positions whose large inputs are read and never
    written by design (params shared by every call, the live pools that
    hydration gathers from) to the reason. ``carry`` is ``(in_argnum,
    out_index)`` locating the carried state in the inputs and outputs
    (``out_index=None``: the whole output is the new state).

    ``branches`` are the values of the entry's static branch argument
    (``static_args[0]``) that the cost pass meters one by one, the
    phase-0 branch first: the reference's generate is ONE program with a
    ``lax.cond`` whose two branches its parser charges apart, the port's
    is one graph a branch. ``cost`` is the static cost contract for the
    cost pass (``repro_torch.analysis.cost``): ``role`` (``"generate"``,
    ``"spec_window"``, ``"prefill"``, ``"prefill_chunk"``, ``"hydrate"``)
    plus ``stride``, ``k``, ``batch``, ``tokens``; ``None`` means the
    entry is only metered for the baseline.
    """
    name: str
    fn: object
    args: tuple
    graph: object = None
    state_args: tuple = ()
    static_args: tuple = ()
    readonly_ok: dict = dataclasses.field(default_factory=dict)
    carry: tuple | None = None
    cost: dict | None = None
    branches: tuple = ()

    def with_branch(self, value) -> tuple:
        """``args`` with the static branch argument set to ``value``."""
        i = self.static_args[0]
        return self.args[:i] + (value,) + self.args[i + 1:]
