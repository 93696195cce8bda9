"""The op recorder: the aten ops a step dispatches, and the hand kernels'
launches, as events.

``OpRecorder`` is a ``TorchDispatchMode`` that keeps one :class:`Event` per
aten op dispatched under it, with the shapes, dtypes and devices of its
inputs and outputs.  It runs on real tensors (CPU or card) and on fake
tensors (``torch._subclasses.FakeTensorMode``: nothing is allocated) alike.
On a ``DTensor`` the recorder steps aside, so it records the local ops and
the collectives DTensor runs for them: the events are per device.  The ops
DTensor runs on whole fake tensors to propagate shapes are not recorded.

The hand-written kernels are launched through ``ctypes``
(``kernels/build.py``), so the dispatcher never sees them: each wrapper
charges the active recorder one ``kernel`` event with the work its function
does (:func:`gemm_work`, :func:`run_kernel`), and the recorder does not
descend into what the wrapper runs, neither the plain version's ops on the
CPU nor the launch's allocations on the card.  A step so records the same
events on the CPU and on the card.  With no recorder active a wrapper pays
one ``None`` check.  ``core.rmpm`` marks its run-time mode choices
(:func:`mark`) for the dispatch audit.

This module sits below the kernels and the core, which charge and mark
through it; ``launch.op_cost`` reads the events as a cost and a roofline,
and ``analysis`` reads them as the dispatch and flow audits.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class TensorMeta(NamedTuple):
    """What the recorder keeps of a tensor: no data, no reference.  ``ident``
    is ``id()`` of the tensor the op saw (unique while it is alive)."""

    shape: tuple
    dtype: torch.dtype
    device: str
    ident: int

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * self.dtype.itemsize


class Event(NamedTuple):
    """One dispatched op (``kind='op'``, ``name`` the aten overload), one
    hand-kernel launch (``'kernel'``, with the work its wrapper charged), or
    a mark a module sets for the audits (``'mark'``, e.g. ``switch``).
    ``group``: the name of the process group a collective op runs on."""

    kind: str
    name: str
    inputs: tuple
    outputs: tuple
    flops: float = 0.0
    nbytes: float = 0.0
    dtype: torch.dtype | None = None
    group: str | None = None


#: the namespaces of the collective ops, whose last string argument names
#: their process group
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


#: the active recorder, or None (the wrappers' only cost when none is)
ACTIVE = None


def meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(t.shape), t.dtype, str(t.device), id(t))


def tensors(tree) -> list[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def gemm_work(m: int, k: int, n: int, passes: float, outputs: int = 1) -> tuple[float, float]:
    """(FLOPs, bytes) of a hand GEMM kernel: ``passes`` retained limb
    products of 2·M·K·N each; each f32 operand read once and each of its
    ``outputs`` f32 results written once.  ``chip_smoke.gemm_bound_ms``
    reads its bound from these terms."""
    return passes * 2.0 * m * k * n, 4.0 * (m * k + k * n + outputs * m * n)


#: op names seen to be views, and the written input positions (tensor
#: positions) of in-place ops, filled by the recorder as it meets them
VIEWS: set[str] = set()
WRITTEN: dict[str, tuple[int, ...]] = {}


def _learn(func) -> None:
    """Classify an op overload once: a view, or the positions among its
    tensor arguments of those it writes in place."""
    name = str(func)
    if name in WRITTEN or name in VIEWS:
        return
    if func.is_view:
        VIEWS.add(name)
        return
    pos, written = 0, []
    for arg in func._schema.arguments:
        kind = str(arg.type)
        if "Tensor" in kind and "[]" not in kind and "?" not in kind:
            if arg.alias_info is not None and arg.alias_info.is_write:
                written.append(pos)
            pos += 1
    WRITTEN[name] = tuple(written)


def _propagation_unrecorded() -> Callable[[], None]:
    """DTensor derives each op's output shape by running the op on whole
    fake tensors (``ShardingPropagator._propagate_tensor_meta_non_cached``),
    in the active fake mode when there is one: that run is not the step's
    work.  While a recorder is active the method runs with recording
    suspended; returns the function that puts it back."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None or getattr(orig, "_unrecorded", False):
        return lambda: None

    def unrecorded(self, *args, **kwargs):
        with suspended():
            return orig(self, *args, **kwargs)

    unrecorded._unrecorded = True
    setattr(ShardingPropagator, name, unrecorded)
    return lambda: setattr(ShardingPropagator, name, orig)


class OpRecorder(TorchDispatchMode):
    """Records the aten ops dispatched under it (see the module docstring).
    ``keep=False`` counts each event without keeping it (a million-op step;
    a subclass reads it in ``add``)."""

    def __init__(self, keep: bool = True, track_memory: bool = False, hold: bool = False):
        super().__init__()
        self.keep = keep
        #: ``hold``: keep every recorded tensor alive with the recorder, so
        #: that an event's ``ident`` names one tensor for the whole run (the
        #: flow audit follows tensors by it; small runs only)
        self.held: list | None = [] if hold else None
        self.track_memory = track_memory
        #: bytes of the storages the recorded ops made that are alive, and
        #: their peak (with ``track_memory``)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self.events: list[Event] = []
        self.n_events = 0
        self.n_ops = 0
        self._suspended = 0

    def __enter__(self):
        from torch._subclasses.fake_tensor import FakeTensor

        global ACTIVE
        self._fake_cls = FakeTensor
        self._prev = ACTIVE
        ACTIVE = self
        self._unpatch = _propagation_unrecorded()
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._prev
        self._unpatch()
        return super().__exit__(*exc)

    def add(self, ev: Event) -> None:
        self.n_events += 1
        self.n_ops += ev.kind == "op"
        if self.keep:
            self.events.append(ev)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in types:
            if t is not torch.Tensor and t is not torch.nn.Parameter \
                    and t is not self._fake_cls:
                return NotImplemented  # a subclass (DTensor): record what it runs
        out = func(*args, **kwargs)
        if self._suspended or func.namespace == "prim":
            return out  # (prim: a fake tensor's device queries, not work)
        ins = tensors((args, kwargs))
        outs = tensors(out)
        _learn(func)
        name = str(func)
        if self.track_memory and name not in VIEWS and not WRITTEN.get(name):
            self._allocated(outs)
        if self.held is not None:
            self.held.append((ins, outs))
        group = None
        if func.namespace in COLLECTIVE_NAMESPACES:
            group = next((a for a in reversed(args) if isinstance(a, str)), None)
        self.add(Event("op", name, tuple(meta(t) for t in ins),
                       tuple(meta(t) for t in outs), group=group))
        return out

    def _allocated(self, outs) -> None:
        """Count the new storages among an op's outputs as live until freed."""
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            self._live[key] = n = st.nbytes()
            self.live_bytes += n
            weakref.finalize(st, self._freed, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)


@contextlib.contextmanager
def suspended():
    """Record no op while inside (a hand kernel's wrapper body)."""
    rec = ACTIVE
    if rec is None:
        yield
        return
    rec._suspended += 1
    try:
        yield
    finally:
        rec._suspended -= 1


def charge(name: str, inputs, outputs, *, flops: float = 0.0, nbytes: float | None = None,
           dtype: torch.dtype | None = None) -> None:
    """Charge the active recorder one ``kernel`` event (no-op when none is
    active).  ``nbytes`` defaults to one read of the inputs and one write of
    the outputs."""
    rec = ACTIVE
    if rec is None or rec._suspended:
        return
    if rec.held is not None:
        rec.held.append((tuple(inputs), tuple(outputs)))
    ins = tuple(meta(t) for t in inputs)
    outs = tuple(meta(t) for t in outputs)
    if nbytes is None:
        nbytes = float(sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs))
    rec.add(Event("kernel", name, ins, outs, flops, nbytes, dtype))


def run_kernel(name: str, run: Callable[[], Any], inputs, *, flops: float = 0.0,
               nbytes: float | None = None, dtype: torch.dtype | None = None):
    """``run()`` (a wrapper's launch or plain version) with recording
    suspended, then one ``kernel`` event charged for it.  A wrapper's
    pre-pass (GRTE's quantize) runs before ``run`` and charges its own."""
    rec = ACTIVE
    rec._suspended += 1
    try:
        out = run()
    finally:
        rec._suspended -= 1
    charge(name, inputs, tensors(out), flops=flops, nbytes=nbytes, dtype=dtype)
    return out


def mark(name: str, *ts) -> None:
    """A mark event for the audits (``switch``: a run-time mode choice)."""
    rec = ACTIVE
    if rec is None or rec._suspended:
        return
    rec.add(Event("mark", name, tuple(meta(t) for t in ts), ()))
