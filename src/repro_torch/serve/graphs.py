"""Compiled serving steps: each a CUDA graph captured once and replayed.

The port's counterpart of the reference's ``jax.jit`` steps
(``src/repro/serve/engine.py``: the masked step at ``:264``, the modal step
and the probe at ``:327-328``, the speculative round at ``:375``).  Eagerly,
one decode step of ``qwen1.5-0.5b`` is about 2,000 separate PyTorch calls
and kernel launches, and the host, not the card, sets its pace; a replay
hands the whole step to the card in one call.

A :class:`CompiledStep` wraps a step function of no arguments that reads
and writes only buffers which outlive it: the engine's static inputs
(tokens, active rows, the device views of its mode tables) and its static
decode state.  The function must not read a host value back or build a
tensor from host data.

* On a CUDA device the first call warms the step up on a side stream
  (building the kernel library, filling the plan and SM-count caches,
  initialising cuBLAS), puts back the buffers the warm-up wrote, captures
  the function into one ``torch.cuda.CUDAGraph``, and replays it; every
  later call is one ``replay()``.  A capture or a replay that fails raises:
  there is no fall back to eager.
* On the CPU, and on the card inside :func:`eager` (the counterpart of
  ``jax.disable_jit``), the same function runs eagerly on the same
  buffers.

With its ``tracer`` on, a step times its blocks on the device
(repro_torch.obs.device): the capture runs inside a ``Recording``, so the
graph holds a pair of timing-event nodes at every device span and each
replay records them again, and two plain events around ``replay()`` time
the whole replay; eagerly, each call records afresh.  :meth:`CompiledStep.read` gives both after the caller's sync.
With the tracer off the graph holds no event node.  Each capture is a
``capture`` span on the tracer.

``kernels.build.LAUNCHES`` (and ``BODY_LAUNCHES``) are counted by the
kernels' Python wrappers, which a replay does not run: the launches a
capture recorded are added per replay instead, so launch counts stay true
under replay.

The steps of one engine capture into ONE private memory pool (``pool``,
``torch.cuda.graph_pool_handle``): they are replayed one at a time and the
engine reads each step's outputs before the next replay, so their
temporaries may share memory (at RecurrentGemma-9b's width the logits'
limbs alone take over 10 GB a graph).  A step holds its function weakly (a
bound method of the engine), so an engine and its steps form no reference
cycle: a dropped engine frees its graphs, and with them the pool, at once,
not at the next cycle collection.  :meth:`CompiledStep.close` drops a
graph explicitly.
"""
from __future__ import annotations

import contextlib
import inspect
import time
import weakref
from typing import Callable

import torch

from repro_torch.kernels import build
from repro_torch.obs import NULL_TRACER
from repro_torch.obs.device import NULL_SPAN, Recording

#: depth of open ``eager()`` contexts (the engine steps from one thread)
_EAGER = [0]


@contextlib.contextmanager
def eager():
    """Run every compiled step eagerly, on the card too, while the context
    is open — for comparing a captured run with an eager one.  Graphs
    already captured are kept and replayed again after the context."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def _weakly(fn: Callable | None) -> Callable | None:
    """``fn`` without a strong reference to the object it is bound to: a
    bound method is called through a ``weakref.WeakMethod``; any other
    callable is kept as it is."""
    if fn is None or not inspect.ismethod(fn):
        return fn
    ref = weakref.WeakMethod(fn)
    name = fn.__qualname__

    def call():
        method = ref()
        if method is None:
            raise RuntimeError(f"{name}: its object is gone")
        return method()

    return call


class CompiledStep:
    """One compiled step: ``fn`` captured once as a CUDA graph on ``device``
    and replayed on every call (see the module docstring).

    ``snapshot``: when ``fn`` writes persistent buffers (the static decode
    state), a callable that saves what one run of ``fn`` overwrites and
    returns the function that puts it back; the warm-up's writes are undone
    with it before the capture.  ``pool``: the memory pool to capture into
    (shared by the steps of one engine), or None for a pool of its own.
    Both callables are held weakly when they are bound methods.
    ``tracer``: where each capture is a ``capture`` span; while it is on,
    the step times its device spans and the whole call (:meth:`read`).
    """

    def __init__(self, fn: Callable[[], object], device, *, name: str,
                 snapshot: Callable[[], Callable[[], None]] | None = None,
                 pool=None, tracer=NULL_TRACER):
        self.fn = _weakly(fn)
        self.device = torch.device(device)
        self.name = name
        self.snapshot = _weakly(snapshot)
        self.pool = pool
        self.tracer = tracer
        #: the device spans of the last call: the capture's (replayed), or
        #: the last eager call's; and the stamps around that whole call
        self.recording: Recording | None = None
        self._graph_recording: Recording | None = None
        self._whole = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        #: kernel launches one replay makes, recorded at capture, by kernel
        #: and by device body
        self.launches: dict[str, int] = {}
        self.body_launches: dict[str, int] = {}
        self.captures = 0
        self.replays = 0
        #: host seconds of the last warm-up and capture together
        self.capture_s: float | None = None

    def __call__(self):
        if self.device.type != "cuda" or _EAGER[0]:
            if not self.tracer.enabled:
                return self.fn()
            rec = self.recording = Recording(self.device)
            start = rec.stamp()
            with rec:
                out = self.fn()
            self._whole = (start, rec.stamp())
            return out
        if self.graph is None:
            self._capture()
        if self.tracer.enabled:
            rec = self.recording = self._graph_recording
            start = rec.stamp()
            self.graph.replay()
            self._whole = (start, rec.stamp())
        else:
            self.graph.replay()
        for counts, recorded in ((build.LAUNCHES, self.launches),
                                 (build.BODY_LAUNCHES, self.body_launches)):
            for name, n in recorded.items():
                counts[name] += n
        self.replays += 1
        return self.outputs

    def read(self) -> tuple[float, dict[str, float], dict[str, int]]:
        """After the last call's sync: its device ms, and each device span's
        ms and count (``Recording.read``).  Only with the tracer on."""
        rec = self.recording
        return (rec.elapsed_ms(*self._whole),) + rec.read()

    def _capture(self) -> None:
        with self.tracer.span("capture", name=self.name) as sp:
            self._capture_graph()
        if self.tracer.enabled:
            sp.data["capture_s"] = self.capture_s

    def _capture_graph(self) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        restore = self.snapshot() if self.snapshot is not None else None
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.fn()  # real launches: LAUNCHES counts them
        current.wait_stream(side)
        if restore is not None:
            restore()
        del restore
        # the warm-up's freed blocks go back to the card, so the graph's
        # pool can take them (a large model's step cannot hold both)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        before, before_body = build.launch_counts(), build.body_launch_counts()
        rec = Recording(self.device) if self.tracer.enabled else NULL_SPAN
        with torch.cuda.graph(graph, pool=self.pool), rec:
            outputs = self.fn()
        if self.tracer.enabled:
            self._graph_recording = rec
        after, after_body = build.launch_counts(), build.body_launch_counts()
        # a capture enqueues nothing: what the wrappers counted meanwhile is
        # what each replay will launch
        self.launches = {name: after[name] - before[name] for name in after}
        self.body_launches = {name: after_body[name] - before_body[name] for name in after_body}
        build.LAUNCHES.update(before)
        build.BODY_LAUNCHES.update(before_body)
        self.graph, self.outputs = graph, outputs
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def close(self) -> None:
        """Drop the graph and its outputs (their memory goes back to the
        pool, and the pool to the allocator once no graph holds it).  A
        later call captures again."""
        self.graph = None
        self.outputs = None
        self.pool = None
        self.recording = self._graph_recording = None
