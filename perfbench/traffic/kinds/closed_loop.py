"""Closed loop: ``clients`` clients, each sending its next request the
moment its last one finishes (no think time).

Lengths come from a pool of ``pool`` requests drawn from the ``prompt`` and
``output`` distributions, paired by one fixed draw (outputs cut to fit
``max_len`` behind their prompt), so every run's seed gets the same pairs
in its own order; they are handed out in that order (and again from its
start, should a window use it up).  The window opens on a loop in steady
state: the first request of each client is taken as already part
way through its output, at a progress of ``(j + 0.5) / clients`` (in a
seeded order); the part it has already produced is sent as more prompt
(prefilled in set-up, at most ``max_prefill`` tokens in all) and the rest
is its budget.  So every slot is busy when the window opens and the
clients finish, and send anew, at staggered points.
"""
from __future__ import annotations

import numpy as np

from harness import gen


class Load:
    closed = True

    def __init__(self, spec: dict, seed: int, vocab: int, seconds: float):
        self.spec, self.vocab = spec, vocab
        n = spec["pool"]
        prompts = gen.quantiles(spec["prompt"], n)
        outs = gen.rng_for(0, 1).permutation(gen.quantiles(spec["output"], n))
        outputs = np.minimum(outs, spec["max_len"] - prompts)
        rng = gen.rng_for(seed, 1)
        order = rng.permutation(n)
        self.prompts, self.outputs = prompts[order], outputs[order]
        self.progress = rng.permutation((np.arange(spec["clients"]) + 0.5) / spec["clients"])
        self.tok_rng = gen.rng_for(seed, 2)
        self.next = 0

    def _take(self) -> tuple[int, int]:
        i = self.next % len(self.prompts)
        self.next += 1
        return int(self.prompts[i]), int(self.outputs[i])

    def warm(self) -> list[tuple[np.ndarray, int]]:
        """(prompt, max_new) of each client's first request."""
        out = []
        for f in self.progress:
            p, o = self._take()
            h = min(int(f * o), max(self.spec["max_prefill"] - p, 0), o - 2)
            out.append((gen.tokens(self.tok_rng, self.vocab, p + h), o - h))
        return out

    def due(self, t: float) -> list[tuple[float, np.ndarray, int]]:
        return []

    def next_due(self) -> float | None:
        return None

    def replace(self) -> tuple[np.ndarray, int]:
        """The next request of a client whose request just finished."""
        p, o = self._take()
        return gen.tokens(self.tok_rng, self.vocab, p), o
