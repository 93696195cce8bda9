"""KV-cache layouts behind one protocol.  Only the dense layout is ported.

The engine talks to its decode state through a :class:`KVLayout`

    init / gather_row / scatter_row / free_row /
    can_admit / prepare_step / tier_tick / describe

so that prefill, park/resume and the masked step never see the layout.  The
exchange format is the *dense solo row*: ``gather_row`` returns the same
per-slot batch-1 ``DecodeState`` the solo prefill produces.

:class:`DenseLayout` is the per-slot ring cache: every row owns ``max_len``
rows of every cache up front, so all hooks but gather/scatter are trivial.
The reference's jitted ``dynamic_slice`` gather/scatter become indexing.
The paged layout (page-table pools, prefix sharing, precision-tiered pages)
is not ported yet: ``CacheConfig(layout="paged")`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm import DecodeState, map_state
from repro_torch.obs import NULL_TRACER
from repro_torch.serve.config import CacheConfig

#: axes sentinel of the reference for leaves shared by every row (paged
#: pools).  Every leaf of the dense state has its batch axis at 0.
SHARED = -1
BATCH_AXIS = 0


def compute_axes(state: DecodeState) -> DecodeState:
    """Per-leaf batch-axis tree of a per-slot decode state.  The reference
    finds the axis by diffing abstract shapes at two slot counts, because its
    caches carry a stacked layer axis in front; the port keeps one cache per
    layer, so the batch axis of every leaf is 0."""
    return map_state(lambda x: BATCH_AXIS, state)


class KVLayout:
    """Protocol of the cache layouts (see module docstring)."""

    name = "abstract"
    axes = None
    #: trace sink (repro_torch.obs) — the engine swaps in its live tracer
    tracer = NULL_TRACER

    def init(self):
        raise NotImplementedError

    def gather_row(self, state, slot: int):
        raise NotImplementedError

    def scatter_row(self, state, row, slot: int, *, prompt=None, length=None):
        raise NotImplementedError

    def free_row(self, state, slot: int):
        return state

    def begin_admission(self) -> None:
        pass

    def can_admit(self, n_tokens: int, prompt=None) -> bool:
        return True

    def prepare_step(self, state, lengths: dict[int, int], ahead: int):
        return state, []

    def tier_tick(self, state, lengths: dict[int, int], step: int):
        return state, None

    def page_stats(self) -> dict | None:
        return None

    def describe(self) -> str:
        raise NotImplementedError


class DenseLayout(KVLayout):
    """The per-slot ring cache.  Slots are the only resource."""

    name = "dense"

    def __init__(self, model, slots: int, max_len: int):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.axes = compute_axes(model.init_decode_state(1, 1, per_slot=True))

    def init(self) -> DecodeState:
        return self.model.init_decode_state(self.slots, self.max_len, per_slot=True)

    def gather_row(self, state: DecodeState, slot: int) -> DecodeState:
        """Row ``slot`` as a batch-1 state (a copy: it outlives the step)."""
        return map_state(lambda s: s[slot:slot + 1].clone(), state)

    def scatter_row(self, state: DecodeState, row: DecodeState, slot: int, *,
                    prompt=None, length=None) -> DecodeState:
        """Write a batch-1 row into ``slot``.  Out of place, like every state
        update of the port: the other rows are copied bit for bit."""
        def put(s, r):
            out = s.clone()
            out[slot:slot + 1] = r.to(s.dtype)
            return out

        return map_state(put, state, row)

    def describe(self) -> str:
        return (f"dense ring cache: {self.slots} slots x {self.max_len} "
                f"rows (admission on free slots)")


def make_layout(cfg: CacheConfig, model, slots: int, max_len: int) -> KVLayout:
    """Layout factory for the engine: ``CacheConfig.layout`` selects."""
    if cfg.layout == "paged":
        raise NotImplementedError(
            "CacheConfig(layout='paged') is not ported yet (ROADMAP Queue A "
            "item 8, 'Paged KV cache'); use layout='dense'")
    return DenseLayout(model, slots, max_len)
