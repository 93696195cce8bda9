"""Precision-flow checker: abstract interpretation over a step's recorded ops.

The reference's ``repro.analysis.flow`` walks a traced jaxpr; the port's
steps are eager, so the walk is over the op recorder's events
(``launch.op_cost.record_ops``), each with the dtypes and identities of its
inputs and outputs.  The lattice value of a float tensor is its *effective
mantissa width* in bits — ``float64`` 53, ``float32`` 24, ``float16`` 11,
``bfloat16`` 8.  A ``quantize_mantissa`` kernel event lowers the value
(keeps the storage dtype but truncates mantissa content); a dtype
conversion moves it between storage widths.  Four contracts from the
paper's run-time-reconfigurable datapath are checked:

``FLOW-F64``
    No float64 tensor may appear in a device path.  An f64 tensor in the
    port is always explicit (PyTorch has no silent x64 switch to trace
    under, and Python floats reach ops as scalars, not tensors), so the
    rule needs no ``enable_x64``.

``FLOW-WIDEN``
    Every conversion that *widens* a float must be on an allowlisted
    accumulation edge (default: ``bfloat16 -> float32``, the
    limb-accumulation contract).  Anything else is a silent upcast that
    would mask the configured precision.

``FLOW-MODE``
    Mode-select arguments must reach the step as int32 tensors, be consumed
    by at least one op, and never be read back to the host
    (``aten._local_scalar_dense`` on the mode or an integer tensor made
    from it).  An unused mode means the Python body folded the mode; a
    read-back is a sync that a captured step cannot make.

``FLOW-NARROW``
    ``quantize_mantissa`` kernel events (those whose name contains
    ``quantize_mantissa``) may only *narrow* the lattice value: output
    storage bits must not exceed the input's lattice bits.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.report import Violation
from repro_torch.launch import op_cost

#: mantissa bits (incl. implicit leading 1) per float storage dtype
MANTISSA_BITS = {
    "float64": 53,
    "float32": 24,
    "float16": 11,
    "bfloat16": 8,
}

#: float widenings that are part of the datapath contract (limb products
#: accumulate in f32; everything else must justify itself per-path)
DEFAULT_WIDEN_ALLOW = (("bfloat16", "float32"),)

#: ops that convert dtypes (the reference's ``convert_element_type``)
_CONVERTS = frozenset({"_to_copy", "copy_"})


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _bits(meta) -> int | None:
    return MANTISSA_BITS.get(_name(meta.dtype))


def _base(name: str) -> str:
    parts = name.split(".")
    return parts[1] if len(parts) >= 3 else name


def _mode_leaves(arg) -> list:
    """The leaves of one mode argument: a scalar or a dict of per-site
    scalars (a ModeTable's ``scalars()`` / ``DeviceModes`` view)."""
    if isinstance(arg, dict):
        return [x for k in sorted(arg) for x in _mode_leaves(arg[k])]
    if isinstance(arg, (tuple, list)):
        return [x for v in arg for x in _mode_leaves(v)]
    return [arg]


def analyze_flow(fn, *args, path: str, mode_args: tuple[int, ...] = (),
                 widen_allow=DEFAULT_WIDEN_ALLOW, **kwargs) -> list[Violation]:
    """Record ``fn(*args, **kwargs)`` and run all four flow rules.

    ``mode_args`` are positional indices (into ``args``) of mode-select
    scalars (or dicts of per-site scalars)."""
    _, rec = op_cost.record_ops(fn, *args, hold=True, **kwargs)
    modes = [(idx, _mode_leaves(args[idx])) for idx in mode_args]
    return flow_violations(rec.events, path, modes=modes, widen_allow=widen_allow)


def flow_violations(events, path: str, *, modes=(), widen_allow=DEFAULT_WIDEN_ALLOW
                    ) -> list[Violation]:
    """All four flow rules over recorded events.  ``modes``: (argument
    index, its leaves) per declared mode argument; the leaves must be the
    objects the recorded run was given (identity is how an op's input is
    matched to them)."""
    out: list[Violation] = []
    allow = {tuple(pair) for pair in widen_allow}
    seen_f64: set[str] = set()
    env: dict[int, int] = {}  # tensor ident -> effective mantissa bits

    def lattice(meta) -> int | None:
        b = _bits(meta)
        return None if b is None else env.get(meta.ident, b)

    def note_f64(meta, what: str) -> None:
        if meta.dtype == torch.float64 and what not in seen_f64:
            seen_f64.add(what)
            out.append(Violation(
                "FLOW-F64", path,
                f"float64 on device path at {what} (narrow the source)"))

    for ev in events:
        if ev.kind == "mark":
            continue
        for m in ev.inputs:
            note_f64(m, f"{ev.name} in")
        for m in ev.outputs:
            note_f64(m, f"{ev.name} out")
        base = _base(ev.name)
        if ev.kind == "op" and base in _CONVERTS and ev.inputs and ev.outputs:
            src = ev.inputs[-1] if base == "copy_" else ev.inputs[0]
            dst = ev.outputs[0]
            sb, db = _bits(src), _bits(dst)
            pair = (_name(src.dtype), _name(dst.dtype))
            if sb is not None and db is not None and db > sb and pair not in allow:
                out.append(Violation(
                    "FLOW-WIDEN", path,
                    f"un-allowlisted float widening {pair[0]} -> {pair[1]}"))
        if ev.kind == "kernel" and "quantize_mantissa" in ev.name:
            in_bits = [b for b in (lattice(m) for m in ev.inputs) if b is not None]
            for m in ev.outputs:
                ob = _bits(m)
                if ob is None:
                    continue
                src_bits = max(in_bits) if in_bits else ob
                if ob > src_bits:
                    out.append(Violation(
                        "FLOW-NARROW", path,
                        f"quantize site '{ev.name}' widens the lattice: "
                        f"{src_bits} -> {ob} mantissa bits"))
                env[m.ident] = min(ob, src_bits)

    out.extend(_mode_violations(events, path, modes))
    return out


def _mode_violations(events, path: str, modes) -> list[Violation]:
    out: list[Violation] = []
    for arg_idx, leaves in modes:
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        for x in leaves:
            dt = _name(x.dtype) if isinstance(x, torch.Tensor) else type(x).__name__
            if dt != "int32":
                out.append(Violation(
                    "FLOW-MODE", path,
                    f"mode arg {arg_idx} has a leaf of {dt}, must be an int32 tensor"))
        # idents of the mode's leaves and of every integer tensor made from them
        tainted = {id(x) for x in tensors}
        consumed = False
        for ev in events:
            if ev.kind != "op":
                continue
            if any(m.ident in tainted for m in ev.inputs):
                consumed = True
                if _base(ev.name) == "_local_scalar_dense":
                    out.append(Violation(
                        "FLOW-MODE", path,
                        f"mode arg {arg_idx} is read back to the host "
                        f"({ev.name}): a sync no captured step can make"))
                for m in ev.outputs:
                    if not m.dtype.is_floating_point:
                        tainted.add(m.ident)
        if leaves and not consumed:
            out.append(Violation(
                "FLOW-MODE", path,
                f"mode arg {arg_idx} is never consumed — the mode was "
                "folded in Python, breaking the zero-rebuild contract"))
    return out
