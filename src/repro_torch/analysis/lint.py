"""Capture-hygiene linter: AST rules for the port's PyTorch code.

The reference's ``repro.analysis.lint`` (``src/repro/analysis/lint.py``),
run over ``src/repro_torch``.  Static source checks that the recorded-op
passes cannot express — they look at what the *Python* does around the
steps the port captures, not at the ops it dispatches.  Each rule has a
stable ID, a docstring in :data:`RULES`, and a per-file allowlist in
:data:`ALLOWLIST` (suffix-matched paths, so moves within ``src/`` keep
working).

The reference's jit bodies become the bodies the port captures as CUDA
graphs: the functions handed to ``serve.graphs.CompiledStep`` and the
functions of the same module they call (``self.f(...)`` or ``f(...)``),
transitively.  Their parameters are device tensors (or trees of them),
except ``self`` and parameters with a literal default (host settings: the
counterpart of static argnames).  A capture records device work only: a
host read of a tensor's value syncs, which capture refuses, and a value
read at capture time would be baked into every replay — the port's
counterpart of a retrace.

``TH001`` host-branch-on-tensor
    ``if`` / ``while`` / conditional expressions inside a captured body
    whose test reads a tensor parameter's *value*.  Metadata access
    (``.shape``/``.ndim``/``.dtype``/``.device``/...), ``is None``
    checks, ``isinstance``/``len`` are fine and excluded.

``TH002`` wallclock-timing
    ``time.time()`` anywhere in ``src/``.  Duration spans must use
    ``time.perf_counter()`` (monotonic — wall clock can step backwards
    under NTP adjustment); genuine wall-clock *metadata stamps* are
    allowlisted per file.

``TH003`` host-read-in-capture
    ``np.*`` / ``numpy.*`` calls, ``float()``/``int()``/``bool()``
    coercions, or ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``
    applied to tensor parameters inside a captured body: each reads the
    value back to the host (host math on ``x.shape`` is fine).

``TH004`` device-probe-in-capture
    ``torch.cuda.is_available()`` / ``resolve_device()`` called inside a
    captured body.  Device resolution belongs to the shell that builds the
    engine, not to a body replayed as recorded.

``TH005`` mutable-default
    Mutable literals (``[]``/``{}``/``set()``/``list()``/``dict()``) as
    function parameter defaults or as bare dataclass field defaults.
    Config dataclasses are compared and hashed as cache keys here;
    mutable defaults alias across instances.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.report import Violation

#: rule catalogue: ID -> one-line summary (full semantics in module docstring)
RULES = {
    "TH001": "host Python branch on a tensor's value inside a captured body",
    "TH002": "time.time() used where a monotonic clock is required",
    "TH003": "host read of a tensor's value inside a captured body",
    "TH004": "device probe inside a captured body",
    "TH005": "mutable default argument / dataclass field default",
}

#: per-rule path-suffix allowlist (the only sanctioned escapes)
ALLOWLIST: dict[str, tuple[str, ...]] = {
    # manifest stamps are *metadata* — wall-clock is the point
    "TH002": ("checkpoint/manager.py",),
}

#: attribute reads that are static metadata, not tensor values
METADATA_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "size", "itemsize", "device", "is_cuda",
     "placements", "device_mesh", "layout", "requires_grad", "dim", "numel",
     "element_size"})

#: host calls that never concretize (operate on metadata / types)
_SAFE_CALLS = frozenset(
    {"isinstance", "len", "getattr", "hasattr", "callable", "type", "repr",
     "str", "id"})

_COERCIONS = frozenset({"float", "int", "bool", "complex"})

#: tensor methods that read the value back to the host
_HOST_READS = frozenset({"item", "tolist", "cpu", "numpy"})

#: calls that probe the device
_PROBES = frozenset({"is_available", "resolve_device"})


def allowed(rule: str, path: str) -> bool:
    norm = path.replace(os.sep, "/")
    return any(norm.endswith(sfx) for sfx in ALLOWLIST.get(rule, ()))


def lint_source(text: str, path: str) -> list[Violation]:
    """Run every rule over one file's source."""
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as exc:
        return [Violation("TH000", f"{path}:{exc.lineno}",
                          f"file does not parse: {exc.msg}")]
    out: list[Violation] = []
    for node, statics in _captured_functions(tree):
        out.extend(_lint_captured_body(node, statics, path))
    out.extend(_lint_wallclock(tree, path))
    out.extend(_lint_mutable_defaults(tree, path))
    return [v for v in out if not allowed(v.rule, path)]


def lint_file(path: str) -> list[Violation]:
    with open(path) as f:
        return lint_source(f.read(), path)


def lint_paths(root: str) -> tuple[list[Violation], list[str]]:
    """Lint every ``.py`` under ``root``; returns (violations, files)."""
    files: list[str] = []
    out: list[Violation] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                files.append(p)
                out.extend(lint_file(p))
    return out, files


# --------------------------------------------------------------------------
# captured-body discovery

def _is_compiled_step(node: ast.AST) -> bool:
    """Matches ``CompiledStep`` or ``graphs.CompiledStep``."""
    if isinstance(node, ast.Attribute):
        return node.attr == "CompiledStep"
    return isinstance(node, ast.Name) and node.id == "CompiledStep"


def _called_name(node: ast.AST) -> str | None:
    """``f`` of ``f`` / ``self.f`` (a function of this module or a method)."""
    if isinstance(node, ast.Name):
        return node.id
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


#: annotations of host scalars
_HOST_TYPES = frozenset({"int", "bool", "str", "float"})


def _statics(fn: ast.FunctionDef) -> frozenset[str]:
    """Parameters with a literal default or a host-scalar annotation (``ax:
    int``): host settings, not tensors."""
    pos = fn.args.posonlyargs + fn.args.args
    named = list(zip(pos[len(pos) - len(fn.args.defaults):], fn.args.defaults))
    named += [(a, d) for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults)
              if d is not None]
    out = {a.arg for a, d in named if isinstance(d, ast.Constant)}
    out |= {a.arg for a in pos + fn.args.kwonlyargs
            if isinstance(a.annotation, ast.Name) and a.annotation.id in _HOST_TYPES}
    return frozenset(out)


def _captured_functions(tree: ast.Module) -> list[tuple[ast.FunctionDef, frozenset[str]]]:
    """The module's functions handed to ``CompiledStep(...)`` and those they
    call in this module, transitively, each with its static parameters."""
    defs: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    todo = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_compiled_step(node.func) and node.args:
            name = _called_name(node.args[0])
            if name is not None:
                todo.append(name)
    seen: dict[str, ast.FunctionDef] = {}
    while todo:
        name = todo.pop()
        if name in seen or name not in defs:
            continue
        seen[name] = fn = defs[name]
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = _called_name(node.func)
                if callee is not None:
                    todo.append(callee)
    return [(fn, _statics(fn)) for fn in seen.values()]


# --------------------------------------------------------------------------
# TH001 / TH003 / TH004 — rules scoped to a captured body

def _tensor_params(fn: ast.FunctionDef, statics: frozenset[str]) -> frozenset[str]:
    names = [a.arg for a in (fn.args.posonlyargs + fn.args.args
                             + fn.args.kwonlyargs)]
    return frozenset(n for n in names if n not in statics and n != "self")


def _reads_value(node: ast.AST, tensors: frozenset[str]) -> bool:
    """Does evaluating ``node`` read a tensor parameter's *value* (not just
    its metadata)?"""
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.Attribute):
        if node.attr in METADATA_ATTRS:
            return False
        return _reads_value(node.value, tensors)
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute):
        if node.value.attr in METADATA_ATTRS:   # x.shape[0]
            return False
    if isinstance(node, ast.Call):
        fname = node.func
        if isinstance(fname, ast.Name) and fname.id in _SAFE_CALLS:
            return False
        return (_reads_value(fname, tensors)     # x.sum() — a tensor receiver
                or any(_reads_value(c, tensors)
                       for c in list(node.args)
                       + [kw.value for kw in node.keywords]))
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False                        # x is None — identity only
    return any(_reads_value(c, tensors) for c in ast.iter_child_nodes(node))


def _np_rooted(func: ast.AST) -> bool:
    node = func
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id in ("np", "numpy")


def _lint_captured_body(fn: ast.FunctionDef, statics: frozenset[str],
                        path: str) -> list[Violation]:
    tensors = _tensor_params(fn, statics)
    out: list[Violation] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.IfExp, ast.While)):
            if _reads_value(node.test, tensors):
                out.append(Violation(
                    "TH001", f"{path}:{node.lineno}",
                    f"captured body '{fn.name}' branches in host Python on a "
                    "tensor's value — use torch.where or hoist to the shell"))
        elif isinstance(node, ast.Call):
            args = list(node.args) + [kw.value for kw in node.keywords]
            on_traced = any(_reads_value(a, tensors) for a in args)
            fname = node.func
            if _np_rooted(fname) and on_traced:
                out.append(Violation(
                    "TH003", f"{path}:{node.lineno}",
                    f"captured body '{fn.name}' calls numpy on a tensor — "
                    "a host read (use torch ops)"))
            elif (isinstance(fname, ast.Name)
                    and fname.id in _COERCIONS and on_traced):
                out.append(Violation(
                    "TH003", f"{path}:{node.lineno}",
                    f"captured body '{fn.name}' coerces a tensor with "
                    f"{fname.id}() — a host read"))
            elif (isinstance(fname, ast.Attribute) and fname.attr in _HOST_READS
                    and _reads_value(fname.value, tensors)):
                out.append(Violation(
                    "TH003", f"{path}:{node.lineno}",
                    f"captured body '{fn.name}' reads a tensor back with "
                    f".{fname.attr}() — a host read"))
            called = (fname.id if isinstance(fname, ast.Name)
                      else fname.attr if isinstance(fname, ast.Attribute)
                      else "")
            if called in _PROBES:
                out.append(Violation(
                    "TH004", f"{path}:{node.lineno}",
                    f"captured body '{fn.name}' probes the device "
                    f"({called}()) — resolve the device in the shell that "
                    "builds the step"))
    return out


# --------------------------------------------------------------------------
# TH002 / TH005 — module-wide rules

def _lint_wallclock(tree: ast.Module, path: str) -> list[Violation]:
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "time"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "time"):
            out.append(Violation(
                "TH002", f"{path}:{node.lineno}",
                "time.time() — use time.perf_counter() for spans "
                "(wall clock can step backwards); allowlist genuine "
                "metadata stamps"))
    return out


def _mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set") and not node.args
            and not node.keywords)


def _lint_mutable_defaults(tree: ast.Module, path: str) -> list[Violation]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for default in node.args.defaults + [
                    d for d in node.args.kw_defaults if d is not None]:
                if _mutable_default(default):
                    out.append(Violation(
                        "TH005", f"{path}:{default.lineno}",
                        f"mutable default argument in '{node.name}' — "
                        "use None or dataclasses.field(default_factory=...)"))
        elif isinstance(node, ast.ClassDef) and _is_dataclass(node):
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign) and stmt.value is not None
                        and _mutable_default(stmt.value)):
                    out.append(Violation(
                        "TH005", f"{path}:{stmt.lineno}",
                        f"mutable field default on dataclass "
                        f"'{node.name}' — use field(default_factory=...)"))
    return out


def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = (target.id if isinstance(target, ast.Name)
                else target.attr if isinstance(target, ast.Attribute) else "")
        if name == "dataclass":
            return True
    return False
