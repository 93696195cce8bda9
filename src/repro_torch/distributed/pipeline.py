"""GPipe-style pipeline parallelism over a mesh axis.

The reference's ``repro.distributed.pipeline`` on ``torch.distributed``.
``pipeline_apply`` runs a homogeneous layer stack across S pipeline stages:
stage i holds the i-th slice of the stacked parameters; microbatches stream
through the classic (M + S - 1)-step schedule, stage 0 ingesting microbatch
t, with boundary activations handed to the next stage by ``ppermute``.
``ppermute`` is an autograd function over ``batch_isend_irecv`` whose
backward is the reverse permutation, and the last stage's outputs are
replicated at the end by a sum over the axis whose backward hands each rank
its own cotangent: so autograd through the pipeline gives the sequential
stack's gradients, as ``jax.grad`` through the reference's does.

Bubble fraction = (S-1)/(M+S-1) — choose M >> S.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.distributed.sharding import axis_sizes

Tensor = torch.Tensor


def _shift(x: Tensor, group, step: int) -> Tensor:
    """Every rank of ``group`` sends ``x`` to the rank ``step`` places on
    (cyclically) and returns what the rank ``step`` places back sent."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (me + step) % n),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """``jax.lax.ppermute`` with the perm i -> i + 1 (cyclic)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, ct):
        return _shift(ct, ctx.group, -1), None


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``unused`` (permuted activations no stage
    reads: every one at stage 0, the last step's everywhere) made inputs of
    it: their backward then runs, with zero cotangents, so that every rank
    takes part in every step's reverse permutation, step by step from the
    last."""

    @staticmethod
    def forward(ctx, x, *unused):
        ctx.unused = [(u.shape, u.dtype, u.device) for u in unused]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return (ct, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.unused))


class _FromLast(torch.autograd.Function):
    """The last stage's value on every rank (a sum over the axis of the
    last stage's ``x`` and zeros).  The output is replicated, so each rank's
    cotangent is that of the one value: the backward passes it to the last
    stage unchanged (not summed over the ranks)."""

    @staticmethod
    def forward(ctx, x, group, is_last):
        out = x.clone() if is_last else torch.zeros_like(x)
        dist.all_reduce(out, group=group)
        ctx.is_last = is_last
        return out

    @staticmethod
    def backward(ctx, ct):
        return (ct if ctx.is_last else torch.zeros_like(ct)), None, None


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x_microbatches: Tensor,  # (M, microbatch, ...)
    mesh,
    axis: str = "pod",
) -> Tensor:
    """Run ``stage_fn(params_i, x)`` across the ``axis`` mesh dimension as a
    pipeline.  ``stage_params`` leaves are stacked (S, ...): plain tensors
    (the whole stack on every rank) or DTensors sharded ``Shard(0)`` over
    ``axis``.  Returns the (M, microbatch, ...) outputs, replicated over
    the stage axis."""
    n_stages = axis_sizes(mesh)[axis]
    group = mesh.get_group(axis)
    sid = dist.get_rank(group)
    last = n_stages - 1
    m = x_microbatches.shape[0]

    def local(p):
        if isinstance(p, DTensor):
            return p.to_local()[0]  # (1, ...) -> (...)
        return p[sid]

    p_local = tree.unflatten(stage_params, [local(p) for p in tree.leaves(stage_params)])
    outs: list[Tensor | None] = [None] * m
    unused: list[Tensor] = []
    inflight = torch.zeros_like(x_microbatches[0])
    for t in range(m + n_stages - 1):
        if sid == 0 and t:
            unused.append(inflight)
        # stage 0 ingests microbatch t (clamped: its output past the last
        # microbatch never reaches an output), the others consume the
        # activation handed over by the previous stage
        x_in = x_microbatches[min(t, m - 1)] if sid == 0 else inflight
        y = stage_fn(p_local, x_in)
        idx = t - last  # the microbatch the LAST stage emits at step t
        if sid == last and idx >= 0:
            outs[idx] = y
        inflight = _PPermute.apply(y, group)
    zero = torch.zeros_like(x_microbatches[0])
    stacked = torch.stack([zero if o is None else o for o in outs])
    if inflight.requires_grad:
        stacked = _Tie.apply(stacked, *(u for u in unused + [inflight] if u.requires_grad))
    return _FromLast.apply(stacked, group, sid == last)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
