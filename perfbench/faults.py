"""Faults planted under the timed path, for showing that the check catches
them: at tiny sizes in ``tests/test_perfbench_reference.py``, at a cell's
own size through ``readings.py --fault``.  The benchmark's own runs never
plant one.

* ``state_unchanged``: the decode step hands back the state it was given;
* ``half_batch``: the second half of the rows is left out of the decode
  step (their state stays; each hands back the token it was fed);
* ``token_altered``: each request's second token is changed where the
  engine emits it.

A one-chip cell has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "token_altered")


@contextlib.contextmanager
def planted(fault: str, vocab: int):
    from repro_torch.serve.engine import ServeEngine

    if fault == "state_unchanged":
        name = "_plain_step_body"

        def broken(self):
            return self._masked_step(self.params, self._tokens, self.state, self._active_dev)[0]
    elif fault == "half_batch":
        name = "_masked_step"
        real = ServeEngine._masked_step

        def broken(self, params, tokens, state, active):
            keep = active.clone()
            keep[active.shape[0] // 2:] = False
            nxt, merged = real(self, params, tokens, state, keep)
            return torch.where(keep, nxt, tokens[:, 0]), merged
    elif fault == "token_altered":
        name = "_emit"
        real = ServeEngine._emit

        def broken(self, ticket, slot, tok):
            return real(self, ticket, slot, (tok + 1) % vocab if len(ticket.tokens) == 1 else tok)
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    saved = getattr(ServeEngine, name)
    setattr(ServeEngine, name, broken)
    try:
        yield
    finally:
        setattr(ServeEngine, name, saved)
