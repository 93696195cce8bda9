"""Open loop: requests arrive on a Poisson schedule at ``rate`` per second
whatever the system does, so a stall lets a queue build.  Prompt and
output lengths are drawn from ``prompt`` and ``output``; ``warm_prompts``
lists prompt lengths served to completion in set-up (the longest the mix
sends, so the window meets no larger allocation than set-up made).

The schedule (arrival gaps and the lengths in arrival order) is drawn from
the mix's own ``schedule_seed``, so every run replays one trace; the run's
seed draws the token ids (and the weights).  Just under the knee, the
tail of time to first token turns on where the long prompts fall against
the bursts: a schedule drawn anew from each seed made the 80th percentile
read 1.0-2.6 s over six seeds.
"""
from __future__ import annotations

import numpy as np

from harness import gen


class Load:
    closed = False

    def __init__(self, spec: dict, seed: int, vocab: int, seconds: float):
        self.spec, self.vocab = spec, vocab
        rng = gen.rng_for(spec["schedule_seed"], 1)
        n = gen.expected_count(spec["rate"], seconds)
        self.times = gen.poisson_arrivals(spec["rate"], n, rng)
        self.prompts = gen.shuffled_lengths(spec["prompt"], n, rng)
        outs = gen.shuffled_lengths(spec["output"], n, rng)
        self.outputs = np.minimum(outs, spec["max_len"] - self.prompts)
        self.tok_rng = gen.rng_for(seed, 2)
        self.next = 0

    def warm(self) -> list[tuple[np.ndarray, int]]:
        return [(gen.tokens(self.tok_rng, self.vocab, p), self.spec["warm_output"])
                for p in self.spec["warm_prompts"]]

    def due(self, t: float) -> list[tuple[float, np.ndarray, int]]:
        """(due time, prompt, max_new) of every request due by ``t``."""
        out = []
        while self.next < len(self.times) and self.times[self.next] <= t:
            i = self.next
            self.next += 1
            p = int(self.prompts[i])
            out.append((float(self.times[i]), gen.tokens(self.tok_rng, self.vocab, p),
                        int(self.outputs[i])))
        return out

    def next_due(self) -> float | None:
        return float(self.times[self.next]) if self.next < len(self.times) else None

    def replace(self):
        raise RuntimeError("an open loop sends no request in reply to another")
