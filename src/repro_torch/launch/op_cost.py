"""Per-device cost of a step from the ops it dispatches.

The port's counterpart of ``repro.launch.hlo_cost`` (``src/repro/launch/
hlo_cost.py``), which parses a compiled program's HLO text.  The port's
steps are eager PyTorch, so there is no program text: ``record_ops(fn,
*args)`` runs ``fn`` under the op recorder (``repro_torch.oprecord``),
which keeps one event per aten op with its shapes and dtypes, on real or
fake tensors, and one ``kernel`` event per hand-kernel launch, charged by
its wrapper with the work its function does.  A step so counts the same on
the CPU, where the plain versions run, and on the card.

:func:`cost_of` reads the reference's fields from the events (``flops``,
``hbm_bytes``, ``collective_bytes``, ``by_collective``, ``n_collectives``),
with the reference's op classes read as eager ops:

* dot class (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ...): 2 x result x
  contracted FLOPs; operands plus result in bytes;
* every other op that writes memory: one pass over its operands plus its
  result (an in-place op's target counted once);
* views are free.  XLA charges a transpose or reshape that it materialises;
  an eager ``view``, ``expand``, ``as_strided`` or transpose allocates
  nothing and moves no byte until an op reads it;
* gathers: 2 x the result; scatters and ``index_put_``: 2 x the update;
* collectives: the result bytes, per kind, plus 2 x that to HBM.

There are no while bodies to multiply: an eager step dispatches every
iteration of its loops, so the counts are loop-correct by construction.

The bytes are those of the ops as eager PyTorch dispatches them, each op a
pass over memory: they are the traffic of this implementation (its
eager-dispatch bytes), not the least any implementation of the step must
move.  A fused kernel that replaces several ops lowers them.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable

import torch

from repro_torch.oprecord import (
    COLLECTIVE_NAMESPACES,
    VIEWS,
    WRITTEN,
    Event,
    OpRecorder,
    TensorMeta,
)
from repro_torch.plan.cost import F32_FLOPS, HBM_BW, NVLINK_BW, PEAK_FLOPS


def op_base(name: str) -> str:
    """``aten.index_put_.default`` -> ``index_put_``."""
    parts = name.split(".")
    return parts[1] if len(parts) >= 3 else name


#: the dot class
DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
                     "vdot", "_addmm_activation"})
#: ops that read memory by index
GATHER_OPS = frozenset({"index", "index_select", "gather", "embedding", "take",
                        "_unsafe_index"})
#: scatter-class ops -> position of the update operand
SCATTER_OPS = {"scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
               "scatter_reduce": 3, "scatter_reduce_": 3, "index_put": 2, "index_put_": 2,
               "_index_put_impl_": 2, "index_add": 3, "index_add_": 3, "index_copy": 3,
               "index_copy_": 3, "masked_scatter": 2, "masked_scatter_": 2,
               "embedding_dense_backward": 0, "index_fill_": 0, "index_fill": 0}
#: ops that write without reading (result bytes only)
_WRITE_ONLY = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "arange",
               "fill_", "zero_", "new_zeros", "new_ones", "new_full", "scalar_tensor",
               "randn", "rand", "randint", "normal_", "uniform_", "linspace"}
#: ops that neither read nor write memory
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_unsafe_view", "lift_fresh", "lift_fresh_copy", "detach", "alias",
         "_local_scalar_dense", "wait_tensor", "_reshape_alias", "set_", "resize_",
         "record_stream", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "_to_dense"}
#: collective ops -> the reference's kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}


@dataclasses.dataclass
class Cost:
    """Per-device totals, as the reference's ``hlo_cost.Cost``; ``flops_by_dtype``
    splits ``flops`` by the dtype whose rate they run at."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    #: collective bytes by (kind, process group name)
    by_group: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    n_collectives: int = 0
    flops_by_dtype: dict = dataclasses.field(default_factory=lambda: defaultdict(float))


def _dot_flops(base: str, inputs: list[TensorMeta], outputs: list[TensorMeta]) -> float:
    if not outputs:
        return 0.0
    res = 1
    for d in outputs[0].shape:
        res *= int(d)
    ops = inputs[1:] if base in ("addmm", "baddbmm", "addbmm", "addmv", "_addmm_activation") \
        else inputs
    contracted = int(ops[0].shape[-1]) if ops and ops[0].shape else 1
    return 2.0 * res * contracted


def _fold(c: Cost, ev: Event) -> None:
    """Add one event's cost into ``c`` in place."""
    if ev.kind == "kernel":
        c.flops += ev.flops
        if ev.flops:
            c.flops_by_dtype[ev.dtype or torch.bfloat16] += ev.flops
        c.hbm_bytes += ev.nbytes
        return
    if ev.kind != "op":
        return
    nbytes, flops, kind, dt = _op_terms(ev)
    c.hbm_bytes += nbytes
    if kind is not None:
        out_b = sum(t.nbytes for t in ev.outputs)
        c.collective_bytes += out_b
        c.by_collective[kind] += out_b
        c.by_group[(kind, ev.group)] += out_b
        c.n_collectives += 1
    if flops:
        c.flops += flops
        c.flops_by_dtype[dt] += flops


def _op_terms(ev: Event) -> tuple[float, float, str | None, torch.dtype | None]:
    """(hbm bytes, flops, collective kind, flops dtype) of an op event."""
    base = op_base(ev.name)
    ns = ev.name.split(".")[0]
    out_b = sum(t.nbytes for t in ev.outputs)
    if ns in COLLECTIVE_NAMESPACES and base in _COLLECTIVES:
        return 2.0 * out_b, 0.0, _COLLECTIVES[base], None
    if base in DOT_OPS:
        dt = ev.inputs[-1].dtype if ev.inputs else None
        return (out_b + sum(t.nbytes for t in ev.inputs),
                _dot_flops(base, list(ev.inputs), list(ev.outputs)), None, dt)
    if base in _FREE or ev.name in VIEWS:
        return 0.0, 0.0, None, None
    if base in GATHER_OPS:
        return 2.0 * out_b, 0.0, None, None
    if base in SCATTER_OPS:
        pos = SCATTER_OPS[base]
        upd = ev.inputs[pos].nbytes if len(ev.inputs) > pos else out_b
        return 2.0 * upd, 0.0, None, None
    if base in _WRITE_ONLY:
        return float(out_b), 0.0, None, None
    written = WRITTEN.get(ev.name, ())
    in_b = sum(t.nbytes for i, t in enumerate(ev.inputs) if i not in written)
    return float(in_b + out_b), 0.0, None, None


def cost_of(events) -> Cost:
    """Fold the events of a run into one per-device ``Cost``."""
    total = Cost()
    for ev in events:
        _fold(total, ev)
    return total


class CostRecorder(OpRecorder):
    """An op recorder that also folds each event into ``cost`` as it comes
    (with ``keep=False``, a million-op step is counted without its events)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.cost = Cost()

    def add(self, ev: Event) -> None:
        super().add(ev)
        _fold(self.cost, ev)


def record_ops(fn: Callable, *args, keep: bool = True, hold: bool = False,
               **kwargs) -> tuple[Any, CostRecorder]:
    """Run ``fn(*args, **kwargs)`` under a recorder; returns (its result, the
    recorder: ``events``, ``cost``, ``n_events``)."""
    rec = CostRecorder(keep=keep, hold=hold)
    with rec:
        out = fn(*args, **kwargs)
    return out, rec


# --------------------------------------------------------------------------
# Roofline terms (NVIDIA H100 SXM data-sheet constants, plan/cost.py)
# --------------------------------------------------------------------------

def rates() -> dict:
    """FLOP/s by the dtype a product runs in: bf16 / f16 on the tensor cores
    (the limb passes), f32 outside them (TF32 is off:
    ``device.require_full_f32_matmul``); any other dtype at the f32 rate.
    """
    return {torch.bfloat16: PEAK_FLOPS, torch.float16: PEAK_FLOPS, torch.float32: F32_FLOPS}


def roofline_terms(cost: Cost) -> dict:
    """Seconds per term, per device (the cost is per device), with the
    reference's keys.  The collective rate is NVLink's; a 16-wide mesh axis
    spans two 8-GPU nodes, so there the collective term is a lower bound."""
    rate = rates()
    t_compute = 0.0
    counted = 0.0
    for dt, fl in cost.flops_by_dtype.items():
        t_compute += fl / rate.get(dt, F32_FLOPS)
        counted += fl
    t_compute += max(cost.flops - counted, 0.0) / F32_FLOPS
    t_memory = cost.hbm_bytes / HBM_BW
    t_collective = cost.collective_bytes / NVLINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "flops_per_device": cost.flops,
        "flops_by_dtype": {str(k).replace("torch.", ""): v
                           for k, v in cost.flops_by_dtype.items()},
        "hbm_bytes_per_device": cost.hbm_bytes,
        "collective_bytes_per_device": cost.collective_bytes,
        "collective_breakdown": dict(cost.by_collective),
    }


def dot_flops(events) -> float:
    """FLOPs of the dot-class ops and GEMM kernels among ``events``."""
    total = 0.0
    for ev in events:
        if ev.kind == "kernel":
            total += ev.flops
        elif ev.kind == "op":
            base = op_base(ev.name)
            if base in DOT_OPS:
                total += _dot_flops(base, list(ev.inputs), list(ev.outputs))
    return total
