"""Host-sync detector, static half (SYNC001/SYNC003) — port of
``repro.analysis.hostsync``.

AST pass over the port's host driver code (serving loop, sessions, engine
host layer, obs) that flags implicit device->host transfers inside
per-step loops.  A "step loop" is any ``for``/``while`` whose body calls
``.generate(...)``, ``.push(...)``, ``generate_step(...)``, or a local name
bound to a ``CheckedGraph``/``checked_graph`` result.  Inside such a loop:

* ``x.item()``, ``x.tolist()``, ``x.cpu()``, ``x.numpy()``,
  ``np.asarray(x)``, ``np.array(x)``, ``float(x)``, ``int(x)``, ``bool(x)``
  on device values stall the dispatch pipeline with one tiny blocking copy
  per call -> SYNC001;
* ``.convert_to_numpy()`` on the result of a ``generate`` issued in the
  *same* iteration drains synchronously instead of overlapping the next
  dispatched step -> SYNC003.

Name-taint keeps the pass quiet on host-side numpy: a variable assigned
from ``convert_to_numpy()`` / ``host_get`` / ``synchronize`` (or from one
of the syncs above, which already paid the transfer), and anything derived
from it by attribute/subscript/method call, is host-safe, as are loop
indices and plain literals.  A sanctioned transfer
is marked in source with a ``# sync-ok: <reason>`` pragma on the same
line, which suppresses the finding.
"""

from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis.report import Finding

DEFAULT_GLOBS = (
    "src/repro_torch/launch/serve.py",
    "src/repro_torch/engine/session.py",
    "src/repro_torch/engine/soi_engine.py",
    "src/repro_torch/engine/speculative.py",
    "src/repro_torch/obs/*.py",
)

_STEP_CALLS = {"generate", "push", "generate_step"}
_NP_SYNCS = {"asarray", "array"}
_SCALAR_SYNCS = {"float", "int", "bool"}
# tensor methods that copy to the host and wait for the device
_METHOD_SYNCS = {"item", "tolist", "cpu", "numpy"}
_SAFE_PRODUCERS = {"convert_to_numpy", "host_get", "synchronize",
                   *_METHOD_SYNCS}
_GRAPH_FACTORIES = {"CheckedGraph", "checked_graph"}


def repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3]


def _root_name(node):
    # unwrap x.a, x[i], and x.m(...) — a method-call result inherits its
    # receiver's host-safety (rt.get_result_at_slot(i) is as drained as rt)
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _call_attr(node):
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _call_name(node):
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id
    return None


class _FileScan(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings = []
        self.jit_names = set()     # locals bound to graph results
        self.safe = set()          # host-safe (already-drained) names
        self.loop_depth = 0        # >0 while inside a step loop
        self.iter_generated = set()  # names assigned from generate() this
        #                              iteration (for SYNC003)

    # -- taint bookkeeping ------------------------------------------------
    def _is_jit_factory(self, call):
        name = _call_name(call) or _call_attr(call)
        return name in _GRAPH_FACTORIES

    def _is_safe_value(self, node):
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Call):
            attr = _call_attr(node)
            if attr in _SAFE_PRODUCERS or _call_name(node) in _SAFE_PRODUCERS:
                return True
            if _call_name(node) in {"len", "range", "min", "max", "enumerate",
                                    "sum", "time", "now", "clock"}:
                return True
            if attr in {"time", "perf_counter", "monotonic", "now"}:
                return True
        root = _root_name(node)
        return root is not None and root in self.safe

    def _note_assign(self, targets, value):
        names = []
        for t in targets:
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                names.extend(e.id for e in t.elts if isinstance(e, ast.Name))
        if not names:
            return
        if isinstance(value, ast.Call) and self._is_jit_factory(value):
            self.jit_names.update(names)
        if self._is_safe_value(value):
            self.safe.update(names)
        else:
            self.safe.difference_update(names)
        if _call_attr(value) in _STEP_CALLS:
            self.iter_generated.update(names)

    def visit_Assign(self, node):
        self._note_assign(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._note_assign([node.target], node.value)
        self.generic_visit(node)

    # -- loop detection ---------------------------------------------------
    def _is_step_loop(self, node) -> bool:
        for sub in ast.walk(node):
            attr = _call_attr(sub)
            if attr in _STEP_CALLS or _call_name(sub) in _STEP_CALLS:
                return True
            name = _call_name(sub)
            if name in self.jit_names:
                return True
        return False

    def _visit_loop(self, node):
        if self._is_step_loop(node):
            self.loop_depth += 1
            self.iter_generated = set()
            self.generic_visit(node)
            self.loop_depth -= 1
        else:
            self.generic_visit(node)

    visit_For = _visit_loop
    visit_While = _visit_loop

    # -- sync detection ---------------------------------------------------
    def _pragma(self, lineno) -> bool:
        line = self.lines[lineno - 1] if lineno - 1 < len(self.lines) else ""
        return "sync-ok" in line

    def _flag(self, node, code, msg):
        if self._pragma(node.lineno):
            return
        self.findings.append(Finding(
            "hostsync", code, f"{self.path}:{node.lineno}", msg))

    def visit_Call(self, node):
        if self.loop_depth > 0:
            attr = _call_attr(node)
            name = _call_name(node)
            obj = node.func.value if isinstance(node.func,
                                                ast.Attribute) else None
            obj_root = _root_name(obj) if obj is not None else None
            obj_safe = obj is not None and self._is_safe_value(obj)
            if attr in _METHOD_SYNCS and not obj_safe:
                self._flag(node, "SYNC001",
                           f"per-step .{attr}(): one blocking device->host "
                           f"copy per call inside the decode loop")
            elif (attr in _NP_SYNCS and obj_root in {"np", "numpy", "onp"}
                  and node.args and not self._is_safe_value(node.args[0])):
                self._flag(node, "SYNC001",
                           f"per-step np.{attr}() on a device value: "
                           f"implicit synchronous transfer in the decode "
                           f"loop — batch it through "
                           f"ResultTokens.convert_to_numpy")
            elif (name in _SCALAR_SYNCS and node.args
                  and not self._is_safe_value(node.args[0])):
                self._flag(node, "SYNC001",
                           f"per-step {name}() on a device value blocks "
                           f"until the step finishes — extract scalars "
                           f"from the drained numpy copy instead")
            elif (attr == "convert_to_numpy" and obj_root is not None
                  and obj_root in self.iter_generated):
                self._flag(node, "SYNC003",
                           "draining the CURRENT step's results "
                           "synchronously — convert the previous step's "
                           "ResultTokens after dispatching the next step "
                           "so the copy overlaps device compute")
        self.generic_visit(node)


def scan_source(source: str, path: str = "<memory>") -> list:
    scanner = _FileScan(path, source)
    scanner.visit(ast.parse(source))
    return scanner.findings


def run_files(root=None, globs=DEFAULT_GLOBS) -> list:
    root = pathlib.Path(root) if root else repo_root()
    findings = []
    for pattern in globs:
        for path in sorted(root.glob(pattern)):
            rel = path.relative_to(root).as_posix()
            findings.extend(scan_source(path.read_text(), rel))
    return findings


def run(target=None) -> list:
    """Static pass: target-independent (``target`` accepted for pass-runner
    uniformity but unused)."""
    del target
    return run_files()
