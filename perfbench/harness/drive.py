"""The load generator's loop around ``ServeEngine.submit`` / ``step``.

One thread, one process.  Every request is timed from its due time: an
open loop's scheduled arrival, or for a closed loop the moment its client's
previous request finished; a request that waits behind a stalled step
carries that wait.  The host phases are marked with ``record_function``
ranges (``bench.submit``, ``bench.step``, ``bench.wait``) for the traced
run's idle gaps.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class Step:
    """One ``engine.step()`` call: host times around it, the requests it
    admitted (each solo-prefilled, giving its first token) and the rows of
    its decode step in the program's row order."""

    t0: float
    t1: float
    admitted: list[int]
    decode: list[int]


@dataclasses.dataclass
class Timeline:
    prompts: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    max_new: dict[int, int] = dataclasses.field(default_factory=dict)
    due: dict[int, float] = dataclasses.field(default_factory=dict)
    submitted: dict[int, float] = dataclasses.field(default_factory=dict)
    tokens: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    #: host time each served token reached the host, per request
    token_t: dict[int, list[float]] = dataclasses.field(default_factory=dict)
    steps: list[Step] = dataclasses.field(default_factory=list)
    t_open: float = 0.0
    t_close: float = 0.0

    def done(self, rid: int) -> bool:
        return len(self.tokens[rid]) >= self.max_new[rid]


class Driver:
    """Feeds one engine from one traffic ``load`` and records the timeline.
    ``request`` builds the program's request object from (prompt, max_new,
    rid)."""

    def __init__(self, engine, load, request, clock=time.perf_counter):
        self.engine, self.load, self.request, self.clock = engine, load, request, clock
        self.tl = Timeline()
        self._rid = 0
        self.on_step = None  # called after every step with the Step

    def record(self, prompt: np.ndarray, max_new: int, due: float) -> int:
        """Enter a request in the timeline, not (yet) handed to the engine."""
        rid = self._rid
        self._rid += 1
        tl = self.tl
        tl.prompts[rid], tl.max_new[rid], tl.due[rid] = prompt, max_new, due
        tl.tokens[rid], tl.token_t[rid] = [], []
        return rid

    def submit(self, prompt: np.ndarray, max_new: int, due: float) -> int:
        rid = self.record(prompt, max_new, due)
        with torch.profiler.record_function("bench.submit"):
            self.engine.submit(self.request(prompt, max_new, rid))
        self.tl.submitted[rid] = self.clock()
        return rid

    def step(self) -> Step:
        tl = self.tl
        t0 = self.clock()
        with torch.profiler.record_function("bench.step"):
            events = self.engine.step()
        t1 = self.clock()
        admitted, decode, seen = [], [], set()
        for rid, tok in events:
            # a request's first token is its prefill's
            (decode if tl.tokens[rid] else admitted).append(rid)
            seen.add(rid)
            tl.tokens[rid].append(int(tok))
            tl.token_t[rid].append(t1)
        st = Step(t0, t1, admitted, decode)
        tl.steps.append(st)
        if self.on_step is not None:
            self.on_step(st)
        if self.load.closed:
            for rid in seen:
                if tl.done(rid):
                    self.submit(*self.load.replace(), due=t1)
        return st

    def warm(self) -> None:
        """Set-up: send the load's first requests and take the first step
        (their prefills, then the decode step's capture).  An open loop's
        warm requests are served to the end."""
        now = self.clock()
        for prompt, max_new in self.load.warm():
            self.submit(prompt, max_new, due=now)
        self.step()
        if not self.load.closed:
            while self.engine.scheduler.has_work():
                self.step()

    def window(self, seconds: float) -> None:
        """Serve for ``seconds``: the window closes with the first step that
        ends past it (or at its end, when the engine is idle)."""
        tl, load, clock = self.tl, self.load, self.clock
        t_open = tl.t_open = clock()
        end = t_open + seconds
        while True:
            now = clock()
            if now >= end:
                break
            for due, prompt, max_new in load.due(now - t_open):
                self.submit(prompt, max_new, due=t_open + due)
            if self.engine.scheduler.has_work():
                self.step()
                continue
            nxt = load.next_due()
            wake = end if nxt is None else min(end, t_open + nxt)
            with torch.profiler.record_function("bench.wait"):
                time.sleep(max(wake - clock(), 0.0))
        tl.t_close = max(clock(), end)
        # requests that fell due while the last step ran past the close were
        # never handed over: they count, at what they waited by the close
        for due, prompt, max_new in load.due(tl.t_close - t_open):
            self.record(prompt, max_new, t_open + due)
