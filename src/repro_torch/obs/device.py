"""Device spans: the device time of each block of a step, timed by events
the program records at its own block boundaries.

Inside a CUDA graph a profiler cannot say which block launched a kernel:
``record_function`` ranges do not replay, and CUPTI puts every kernel
under ``cudaGraphLaunch``.  So the model marks its blocks itself:

    with device_span("attention"):
        ...

With no :class:`Recording` open, ``device_span`` reads one module-level
value and returns a shared no-op context: it allocates nothing and
launches nothing, so a step captured with tracing off holds no event node.
With a recording open on a CUDA device, each span records a pair of timing
events (``torch.cuda.Event(enable_timing=True, external=True)``) on the
current stream; under stream capture they become event-record nodes of the
graph, so every replay records them again.  On the CPU, where every call
runs eagerly and synchronously, the span takes the host clock instead,
and the tree (names, nesting, counts) is the same.

Spans nest: a span's name is its path from the outermost open span
(``"attention/attn_qk"``).  After the step's own sync, :meth:`Recording.read`
sums each path's pairs, with their counts.  The open recording is one
module-level value, so that a closed check costs one read: the engine
steps from one thread (as ``serve.graphs.eager`` assumes too).
"""
from __future__ import annotations

import contextlib
import time

import torch

#: the recording that ``device_span`` records into, or None
_RECORDING: "Recording | None" = None

#: the one shared no-op context of ``obs``: ``device_span`` with no recording
#: open, ``NullTracer.span``, and the engine's recordings with tracing off
NULL_SPAN = contextlib.nullcontext()


def device_span(name: str):
    """A block boundary: a context that times its body on the device into
    the open recording, or does nothing when none is open."""
    rec = _RECORDING
    return NULL_SPAN if rec is None else _Span(rec, name)


class _Span:
    __slots__ = ("rec", "name", "path", "start")

    def __init__(self, rec: "Recording", name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> None:
        rec = self.rec
        rec._path.append(self.name)
        self.path = "/".join(rec._path)
        self.start = rec.stamp()

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.pairs.append((self.path, self.start, rec.stamp()))
        rec._path.pop()


class Recording:
    """The device spans of one step: ``with recording:`` makes it the open
    one (``device_span`` records into it) until the block ends.  It keeps
    its pairs: a captured graph keeps the recording of its capture, whose
    events every replay records again."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        #: (path, start stamp, end stamp), in the order the spans ended
        self.pairs: list[tuple[str, object, object]] = []
        self._path: list[str] = []
        self._prev: Recording | None = None

    def __enter__(self) -> "Recording":
        global _RECORDING
        self._prev, _RECORDING = _RECORDING, self
        return self

    def __exit__(self, *exc) -> None:
        global _RECORDING
        _RECORDING, self._prev = self._prev, None

    def stamp(self):
        """A point on the device's timeline: a timing event recorded on the
        current stream (CUDA), or the host clock (CPU)."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        return ev

    def elapsed_ms(self, start, end) -> float:
        """Milliseconds between two stamps, both completed (after a sync)."""
        return start.elapsed_time(end) if self.cuda else (end - start) * 1e3

    def read(self) -> tuple[dict[str, float], dict[str, int]]:
        """``({path: ms}, {path: pairs})``: each path's device time summed
        over its pairs, and how many there were."""
        ms: dict[str, float] = {}
        n: dict[str, int] = {}
        for path, start, end in self.pairs:
            ms[path] = ms.get(path, 0.0) + self.elapsed_ms(start, end)
            n[path] = n.get(path, 0) + 1
        return ms, n
