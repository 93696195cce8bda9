"""Training step: loss, gradient accumulation, optimizer.

The reference's ``repro.train.step`` on PyTorch: gradients are autograd's
derivatives of the model's forward, as the reference's are ``jax.grad``'s —
through the plain limb algebra (``impl='xla'``) or one f32 product per site
(``impl='native'``).  The hand-written kernels have no backward pass (nor
have the reference's Pallas kernels), so a policy that sends a site to
``'pallas'`` or ``'tile'`` raises ``NotImplementedError`` at that site
(``kernels.build.refuse_autograd``), where the reference's ``jax.grad``
raises too.

Gradient accumulation over ``accum_steps`` microbatches bounds activation
memory: the reference scans them; here a Python loop sums their gradients
and divides by ``accum_steps``.  The step is eager: nothing is compiled or
captured.

Over a mesh (``make_train_step(model, tcfg, mesh)``, a ``DeviceMesh``) the
state's tensors are ``DTensor``s laid out by ``distributed.sharding``'s
rules, and the step runs under ``use_mesh`` (the model's ``constrain``
sites redistribute its activations) and ``implicit_replication``: the
plain tensors the model makes for itself (RoPE tables, positions, masks,
the vocab iota) hold the same values on every rank, and are read as
replicated.  A plain batch is laid out by ``input_shardings`` first, as
the reference's ``jit`` lays out its ``in_shardings``.  Gradients are
redistributed to their parameters' placements before AdamW; the metrics
come back as plain tensors.  ``grad_compression`` with a 'pod' axis takes
the reference's route: the state lives on ``compress.pod_free(mesh)``
(``state_mesh``), each pod computes its gradients on its own rows of the
batch, the int8 error-feedback reduction (``compress.ef_reduce_tree``) is
the only traffic on 'pod', and the metrics are averaged over 'pod'.
Without a mesh the step is the one-device step, and compression does
nothing, in the reference as here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree
from repro_torch.adapt.runtime_policy import DeviceModes, bind_modes
from repro_torch.distributed.compress import ef_reduce_tree, pod_free
from repro_torch.distributed.sharding import (
    BATCH_AXES,
    NamedSharding,
    axis_sizes,
    constrain,
    input_shardings,
    param_shardings,
    replicated,
    use_mesh,
)
from repro_torch.models.lm import LanguageModel
from repro_torch.optim import adamw

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    accum_steps: int = 1
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-4
    grad_compression: bool = False  # int8 EF compression over the pod axis


def cross_entropy(logits: Tensor, labels: Tensor, z_loss: float,
                  seq_sharded: bool = False) -> Tensor:
    """Mean next-token CE in f32 with optional z-loss (logit drift control).

    The label log-prob is the reference's masked sum over the vocab axis
    (one nonzero term, so the same value a gather gives), kept because it
    is the vocab-parallel form a sharded vocab needs: a gather would
    collect the whole (B, S, V) logits on every rank.  ``seq_sharded``
    names the axis ``constrain`` puts on 'model' (sequence instead of
    vocab); over a mesh the iota is a plain tensor, read as replicated, so
    its ``constrain`` is the identity and the mask follows the logits'
    layout."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    vocab_iota = torch.arange(logits.shape[-1], dtype=torch.int32, device=logits.device)
    vocab_iota = vocab_iota.expand(logits.shape)
    if seq_sharded:
        vocab_iota = constrain(vocab_iota, BATCH_AXES, "model", None)
    else:
        vocab_iota = constrain(vocab_iota, BATCH_AXES, None, "model")
    onehot = vocab_iota == labels.to(device=logits.device, dtype=torch.int32)[..., None]
    ll = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse**2)
    return loss


def make_loss_fn(model: LanguageModel, tcfg: TrainConfig) -> Callable:
    """``loss_fn(params, batch) -> (total, {"loss", "aux_loss"})``."""
    seq_sharded = model.cfg.attn_shard == "sequence"

    def loss_fn(params, batch):
        logits, aux = model.apply(params, batch)
        loss = cross_entropy(logits, batch["labels"], tcfg.z_loss_weight, seq_sharded)
        total = loss + tcfg.aux_loss_weight * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``fn(params, batch) -> (metrics, grads)``: the gradient of
    ``loss_fn``'s first output with respect to every leaf of ``params``
    (autograd over detached leaves that require grad; the caller's tensors
    are not changed).  A leaf the loss does not reach (a stacked tree of
    zero layers: a hybrid cut below one supergroup) gets zeros, as
    ``jax.grad`` gives.  Metrics are detached."""

    def fn(params, batch):
        live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        with torch.enable_grad():
            total, metrics = loss_fn(tree.unflatten(params, live), batch)
            grads = torch.autograd.grad(total, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        return ({k: v.detach() for k, v in metrics.items()},
                tree.unflatten(params, grads))

    return fn


def _microbatch(x: Tensor, n: int, i: int) -> Tensor:
    """Rows [i B/n, (i + 1) B/n) of ``x``.  A DTensor whose rows are sharded
    is gathered over the mesh dims that shard them, sliced, and laid out as
    ``input_shardings`` lays out a batch of that many rows: over those mesh
    dims in order while their product divides the rows, replicated over the
    rest (so each microbatch is spread over as many ranks as it fills; 16
    rows of Kimi-K2's 256 over 'pod' x 'data' = 32 ranks go over 'pod')."""
    rows = x.shape[0] // n
    if isinstance(x, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                      for p in x.placements):
        mesh, placements = x.device_mesh, tuple(x.placements)
        whole = x.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim == 0
                                      else p for p in placements])
        fitted, ranks = [], 1
        for p, size in zip(placements, mesh.shape):
            if isinstance(p, Shard) and p.dim == 0:
                if rows % (ranks * size):
                    p = Replicate()
                else:
                    ranks *= size
            fitted.append(p)
        return whole[i * rows:(i + 1) * rows].redistribute(mesh, fitted)
    return x.reshape((n, rows) + tuple(x.shape[1:]))[i]


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n batches of (B/n, ...), in row order."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a multiple of "
                             f"accum_steps={n}")
    return [{k: _microbatch(x, n, i) for k, x in batch.items()} for i in range(n)]


def make_grad_fn(model: LanguageModel, tcfg: TrainConfig) -> Callable:
    """``fn(params, batch) -> (grads, metrics)`` with ``accum_steps``
    accumulation: the microbatches' gradients summed in order and divided by
    ``accum_steps``; the metrics are the last microbatch's, as the
    reference's scan carries them."""
    grad_fn = value_and_grad(make_loss_fn(model, tcfg))

    def compute_grads(params, batch):
        if tcfg.accum_steps == 1:
            metrics, grads = grad_fn(params, batch)
            return grads, metrics
        acc = None
        for mb in _split_microbatches(batch, tcfg.accum_steps):
            metrics, grads = grad_fn(params, mb)
            acc = grads if acc is None else tree.map_tree(torch.add, acc, grads)
            del grads
        return tree.map_tree(lambda g: g / tcfg.accum_steps, acc), metrics

    return compute_grads


def _compressing(tcfg: TrainConfig, mesh) -> bool:
    return tcfg.grad_compression and mesh is not None and "pod" in axis_sizes(mesh)


def state_mesh(mesh, tcfg: TrainConfig):
    """The mesh the training state lives on: ``mesh``, or with
    ``grad_compression`` over a 'pod' axis the mesh without it
    (``compress.pod_free``)."""
    return pod_free(mesh) if _compressing(tcfg, mesh) else mesh


def state_shardings(params: Any, cfg, mesh, tcfg: TrainConfig) -> dict:
    """The reference launcher's shardings of the training state, on
    ``state_mesh(mesh, tcfg)``: parameters and both moments by
    ``param_shardings``, the step replicated, EF residuals as the
    parameters.  Quantized moments (``quantize_moments``: int8 codes and
    scales blocked along the last dim, ``(..., D/B, B)`` and ``(..., D/B,
    1)``) keep their parameter's layout of the leading dims (experts stay
    on 'model'); the two block dims replicate, as the reference's dry run
    lays them out."""
    smesh = state_mesh(mesh, tcfg)
    ps = param_shardings(params, cfg, smesh)
    ms = ps
    if tcfg.optimizer.quantize_moments:
        def blocks(leaf, sharding):
            lead = tuple(sharding.spec)[:max(len(leaf.shape) - 1, 0)]
            q = NamedSharding(smesh, lead + (None, None))
            return (q, q)

        ms = tree.map_tree(blocks, params, ps)
    out = {"params": ps, "opt": {"step": replicated(smesh), "m": ms, "v": ms}}
    if tcfg.grad_compression:
        out["residual"] = ps
    return out


def _plain(x: Tensor) -> Tensor:
    return x.full_tensor() if isinstance(x, DTensor) else x


def mesh_scope(mesh) -> contextlib.AbstractContextManager:
    """What a step over ``mesh`` runs under: ``use_mesh(mesh)`` and
    ``implicit_replication()`` (nothing with no mesh)."""
    scope = contextlib.ExitStack()
    if mesh is not None:
        scope.enter_context(use_mesh(mesh))
        scope.enter_context(implicit_replication())
    return scope


def laid_out(batch: dict, mesh) -> dict:
    """The batch with every plain leaf (the whole batch, the same on every
    rank) laid out by ``input_shardings``; DTensor leaves as they are."""
    shard = input_shardings(batch, mesh)
    return {k: x if isinstance(x, DTensor) else shard[k].put(x) for k, x in batch.items()}


def _pod_rows(batch: dict, mesh, sub) -> dict:
    """This pod's rows of a batch laid out on ``mesh``, as DTensors on the
    pod-free mesh ``sub`` (the reference's ``in_specs=P('pod')``)."""
    pod = list(axis_sizes(mesh)).index("pod")
    out = {}
    for k, x in batch.items():
        placements = list(x.placements)
        if placements[pod] != Shard(0) and axis_sizes(mesh)["pod"] > 1:
            raise ValueError(f"batch[{k!r}]: {x.shape[0]} rows do not split over 'pod'")
        del placements[pod]
        out[k] = DTensor.from_local(x.to_local(), sub, placements, run_check=False)
    return out


def like_params(grads: Any, params: Any) -> Any:
    """Each gradient in its parameter's placements (a replicated parameter's
    partial sums all-reduced)."""
    def one(g, p):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g
    return tree.map_tree(one, grads, params)


def make_train_step(model: LanguageModel, tcfg: TrainConfig, mesh=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state = {'params', 'opt', 'residual' (optional EF residuals)}``;
    ``batch`` holds ``tokens`` and ``labels`` tensors (and ``frames`` /
    ``pixel_embeds`` for the enc-dec and VLM families).  ``metrics``:
    ``loss``, ``aux_loss``, ``lr``, ``grad_norm``, f32 scalars on the
    device.  The new state's tensors are new: ``state`` stays as it was.
    ``mesh``: see the module's docstring."""
    compute_grads = make_grad_fn(model, tcfg)
    compress = _compressing(tcfg, mesh)
    sub = state_mesh(mesh, tcfg) if mesh is not None else None

    def grads_of(state, batch):
        params = state["params"]
        if mesh is None:
            grads, metrics = compute_grads(params, batch)
            return grads, metrics, state.get("residual")
        batch = laid_out(batch, mesh)
        if compress:
            batch = _pod_rows(batch, mesh, sub)
        grads, metrics = compute_grads(params, batch)
        grads = like_params(grads, params)
        metrics = {k: _plain(v) for k, v in metrics.items()}
        if not compress:
            return grads, metrics, state.get("residual")
        group = mesh.get_group("pod")
        grads, residual = ef_reduce_tree(grads, state["residual"], group)
        names = sorted(metrics)
        both = torch.stack([metrics[k] for k in names])
        dist.all_reduce(both, group=group)
        both = both / dist.get_world_size(group)
        return grads, dict(zip(names, both.unbind())), residual

    def train_step(state, batch):
        with mesh_scope(sub):
            grads, metrics, new_res = grads_of(state, batch)
            params, opt, om = adamw.apply_updates(
                state["params"], grads, state["opt"], tcfg.optimizer)
        metrics = dict(metrics, **{k: _plain(v) for k, v in om.items()})
        new_state = {"params": params, "opt": opt}
        if new_res is not None:
            new_state["residual"] = new_res
        return new_state, metrics

    return train_step


def make_modal_step(train_step: Callable) -> Callable:
    """The reference launcher's modal wrapper: ``step(state, batch, modes)``
    runs ``train_step`` under ``bind_modes``, with ``modes`` (a ModeTable's
    ``scalars()``, host ints) written into int32 device scalars first.  A
    bound site at ``impl='xla'`` then computes the ladder's limb products
    once and selects its mode on the device (``core.rmpm._mode_select``,
    whose ``torch.where`` sends a zero gradient to the modes not chosen, as
    ``lax.switch``'s gradient does): one code path at every mode, nothing
    built when the table shifts."""
    view = None

    def step(state, batch, modes):
        nonlocal view
        if view is None:
            view = DeviceModes(tuple(modes), tree.leaves(state["params"])[0].device)
        view.write(modes)
        with bind_modes(view.scalars):
            return train_step(state, batch)

    return step


def init_train_state(model: LanguageModel, seed: Any, tcfg: TrainConfig) -> dict:
    """Parameters from ``model.init(seed)`` and a fresh optimizer state (and
    zero EF residuals with ``grad_compression``, as the reference makes)."""
    params = model.init(seed)
    state = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
    if tcfg.grad_compression:
        state["residual"] = tree.map_tree(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state
