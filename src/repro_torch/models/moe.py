"""Mixture-of-Experts layer: GShard-style capacity routing.

The reference's layer (``repro.models.moe``) in PyTorch.  Routing groups
are sequence chunks of ``moe_group_size`` tokens; decode (S == 1) groups
over the batch instead, with capacity ``ceil(B * top_k / E) * cf``, so the
rows of one decode step compete for expert slots.  Assignments are ranked
k-major, then by token (every token's first choice before any second
choice); past an expert's capacity they are dropped (combine weight 0).

The reference builds one-hot (G, T, E, C) dispatch and combine tensors and
contracts them with einsums (semantically a gather and a scatter-add).
Here ``_dispatch_combine`` returns each assignment's flat expert slot and
combine weight, and the gather / scatter-add are index operations — at the
reference's rounding points: the gathered tokens are rounded to bf16 before
the experts, the combine weights and the expert outputs are rounded to
bf16, and the combine sums each token's (at most ``top_k``) f32 products
and rounds the sum once to bf16.  Every shape is static (capacity depends
on the group size only) and nothing reads back to the host, so the layer
runs inside a captured decode step.

The expert GEMMs (``"gecd,edf->gecf"``) and the router go through ``pein``
(``"moe_expert"`` / ``"router"`` op classes): general einsums, so they run
the plain limb algebra, as the reference's do outside any Pallas kernel.

Over a ``DeviceMesh`` (the layer's input or weights are ``DTensor``s) the
layer is expert-parallel as the reference's GSPMD lays it out
(``_moe_apply_mesh``): routing groups stay with the rows of the batch
('data'), each rank scatters its own groups' tokens into the slots of its
own experts ('model') with no traffic, the expert weights' D or F is
gathered over 'data' for the products (ZeRO-3) and never their E, and the
combine's f32 sums over each rank's experts are added over 'model' before
the one bf16 rounding.  A decode step's single group spans the ranks that
hold the batch: its (B, K) expert ids are gathered over them so that the
positions and the capacity are the whole batch's.  Routing, capacity,
positions and rounding points are the unsharded layer's; only the order in
which the ranks' partial sums are added differs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import contiguous_stride, shard_slices
from repro_torch.models.layers import Params, dense_init, pein, swiglu_apply, swiglu_init

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg, *, layers: int | None = None) -> Params:
    """The reference's tree: ``router.w`` (D, E), ``gate`` / ``up``
    (E, D, F), ``down`` (E, F, D) and, with ``moe_shared_experts``, a
    ``shared`` SwiGLU of width ``d_ff * moe_shared_experts`` (``layers=L``:
    a leading layer axis on every leaf)."""
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
    lead = () if layers is None else (layers,)
    std = (2.0 / (d + f)) ** 0.5
    dev = gen.device

    def experts(*shape):
        return torch.randn((*lead, *shape), generator=gen, device=dev,
                           dtype=torch.float32) * std

    p = {
        "router": dense_init(gen, d, e, scale=0.02, layers=layers),
        "gate": experts(e, d, f),
        "up": experts(e, d, f),
        "down": experts(e, f, d),
    }
    if cfg.moe_shared_experts:
        p["shared"] = swiglu_init(gen, d, f * cfg.moe_shared_experts, layers=layers)
    return p


def top_k_lower_index_first(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The ``k`` largest values along the last axis and their indices, equal
    values in ascending index order (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: Tensor, router_w: Tensor, cfg) -> tuple[Tensor, Tensor, Tensor]:
    """x: (G, T, D) -> top-k (weights, ids) and the router probabilities
    (for the auxiliary loss)."""
    logits = pein("gtd,de->gte", x, router_w, "router", cfg.policy)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    weights, ids = top_k_lower_index_first(probs, cfg.moe_top_k)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
    return weights, ids, probs


def _one_hot(ids: Tensor, e: int) -> Tensor:
    """int32 one-hot over the last axis (a comparison: ``F.one_hot`` reads
    the ids back to validate them on some devices)."""
    return (ids[..., None] == torch.arange(e, device=ids.device)).to(torch.int32)


def _dispatch_combine(ids: Tensor, weights: Tensor, e: int,
                      capacity: int) -> tuple[Tensor, Tensor]:
    """Each assignment's slot and combine weight.

    ids, weights: (G, T, K).  Returns ``slot`` (G, T, K) int64, the flat
    expert slot ``expert * capacity + position`` of each kept assignment and
    ``e * capacity`` (one past the last slot) for a dropped one, and
    ``combine`` (G, T, K) f32, the weight rounded to bf16 (0 where dropped)
    — the entries of the reference's (G, T, E, C) dispatch and combine
    tensors.  The position in an expert is the reference's k-major running
    count over the group (GShard): earlier tokens, and lower k, win."""
    slot = _slots(ids, e, capacity)
    return slot, _kept_weights(slot, weights, e * capacity)


def _slots(ids: Tensor, e: int, capacity: int) -> Tensor:
    """(G, T, K) expert ids -> each assignment's flat slot (``e * capacity``
    where dropped): ``_dispatch_combine``'s slots."""
    g, t, k = ids.shape
    onehot = _one_hot(ids, e)  # (G, T, K, E)
    flat = onehot.transpose(1, 2).reshape(g, k * t, e)  # k-major
    pos = (torch.cumsum(flat, dim=1) - 1).reshape(g, k, t, e).transpose(1, 2)
    pos = torch.gather(pos, -1, ids.long()[..., None])[..., 0]  # (G, T, K)
    keep = pos < capacity
    return torch.where(keep, ids.long() * capacity + pos,
                       torch.full_like(pos, e * capacity)).long()


def _kept_weights(slot: Tensor, weights: Tensor, dropped: int) -> Tensor:
    """The combine weights: each kept assignment's weight rounded to bf16, 0
    where its slot is ``dropped``."""
    return torch.where(slot < dropped, weights.to(torch.bfloat16).to(torch.float32),
                       torch.zeros_like(weights))


def _gather_tokens(xg: Tensor, slot: Tensor, e: int, capacity: int) -> Tensor:
    """(G, T, D) tokens -> (G, E, C, D) expert inputs, rounded to bf16 and
    back (the reference contracts its bf16 one-hot dispatch with the bf16
    tokens); empty slots are 0.  A dropped assignment writes the extra slot
    ``e * capacity``, which is cut off."""
    return _scatter_tokens(xg.to(torch.bfloat16).to(torch.float32), slot, e, capacity)


def _scatter_tokens(tokens: Tensor, slot: Tensor, e: int, capacity: int) -> Tensor:
    """``_gather_tokens`` of tokens already rounded."""
    g, t, d = tokens.shape
    k = slot.shape[-1]
    src = tokens[:, :, None, :].expand(g, t, k, d)
    xin = torch.zeros((g, e * capacity + 1, d), dtype=torch.float32, device=tokens.device)
    xin.scatter_(1, slot.reshape(g, t * k, 1).expand(g, t * k, d), src.reshape(g, t * k, d))
    return xin[:, :-1].reshape(g, e, capacity, d)


def _combine(out_e: Tensor, slot: Tensor, combine: Tensor) -> Tensor:
    """(G, E, C, D) expert outputs -> (G, T, D): each token's kept outputs,
    rounded to bf16, times its bf16 combine weights, summed in f32 in
    ascending expert order and rounded once to bf16 (then to f32) — the
    reference's bf16 combine einsum with its f32 accumulation."""
    return _combine_sum(out_e, slot, combine).to(torch.bfloat16).to(torch.float32)


def _combine_sum(out_e: Tensor, slot: Tensor, combine: Tensor) -> Tensor:
    """``_combine`` before its rounding: the f32 sums (a slot past the last
    expert's adds 0)."""
    g, e, c, d = out_e.shape
    t, k = slot.shape[1:]
    flat = torch.cat([out_e.to(torch.bfloat16).to(torch.float32).reshape(g, e * c, d),
                      torch.zeros((g, 1, d), dtype=torch.float32, device=out_e.device)], dim=1)
    order = torch.argsort(slot, dim=-1, stable=True)  # ascending expert
    slot, combine = torch.gather(slot, -1, order), torch.gather(combine, -1, order)
    rows = torch.gather(flat, 1, slot.reshape(g, t * k, 1).expand(g, t * k, d))
    prod = rows.reshape(g, t, k, d) * combine[..., None]
    acc = prod[:, :, 0]
    for i in range(1, k):
        acc = acc + prod[:, :, i]
    return acc


def capacity_for(t: int, cfg) -> int:
    """Expert slots per routing group of ``t`` tokens (the reference's
    integer arithmetic)."""
    k, e = cfg.moe_top_k, cfg.moe_experts
    return max(1, int(-(-t * k // e) * cfg.moe_capacity_factor))


def _group_size(s: int, cfg) -> int:
    """Tokens a routing group takes from each row of a (B, S) input: the
    whole row at decode (S == 1: the group is the batch), else
    ``moe_group_size`` (at most S), which must divide S."""
    if s == 1:
        return 1
    gs = min(cfg.moe_group_size, s)
    if s % gs:
        raise ValueError(
            f"MoE routing groups of {gs} tokens do not divide a sequence of {s} "
            f"(moe_group_size={cfg.moe_group_size})")
    return gs


def moe_apply(p: Params, x: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Over a mesh (DTensor input or
    weights): ``_moe_apply_mesh``."""
    if any(isinstance(t, DTensor) for t in (x, p["router"]["w"], p["gate"], p["up"],
                                             p["down"])):
        return _moe_apply_mesh(p, x, cfg)
    policy = cfg.policy
    b, s, d = x.shape
    e = cfg.moe_experts
    gs = _group_size(s, cfg)
    if s == 1:  # decode: group over the batch
        xg = x.reshape(1, b, d)
        t = b
    else:
        xg = x.reshape(b * (s // gs), gs, d)
        t = gs
    capacity = capacity_for(t, cfg)

    weights, ids, probs = _route(xg, p["router"]["w"], cfg)
    slot, combine = _dispatch_combine(ids, weights, e, capacity)
    # load-balance auxiliary loss (Switch): E * <f_e * p_e>
    frac_tokens = _one_hot(ids[..., 0], e).to(torch.float32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)

    xin = _gather_tokens(xg, slot, e, capacity)
    h_gate = pein("gecd,edf->gecf", xin, p["gate"], "moe_expert", policy)
    h_up = pein("gecd,edf->gecf", xin, p["up"], "moe_expert", policy)
    h = F.silu(h_gate) * h_up
    out_e = pein("gecf,efd->gecd", h, p["down"], "moe_expert", policy)
    out = _combine(out_e, slot, combine).reshape(b, s, d)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], x, policy)
    return out, aux


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------


def _layout(n: int, **dims) -> list:
    """Placements on an ``n``-dim mesh: ``dims`` maps a placement to the mesh
    dims that take it (``shard0=``, ``shard1=``, ``partial=``); the rest
    replicate."""
    kinds = {"shard0": Shard(0), "shard1": Shard(1), "partial": Partial()}
    out = [Replicate()] * n
    for kind, where in dims.items():
        for i in where:
            out[i] = kinds[kind]
    return out


def _wrap(local: Tensor, mesh, **dims) -> DTensor:
    """Each rank's ``local`` as one DTensor laid out by ``_layout(**dims)``
    (no traffic)."""
    shape = list(local.shape)
    for dim, kind in enumerate(("shard0", "shard1")):
        for i in dims.get(kind, ()):
            shape[dim] *= mesh.shape[i]
    return DTensor.from_local(local, mesh, _layout(mesh.ndim, **dims), run_check=False,
                              shape=tuple(shape), stride=contiguous_stride(shape))


def _summed(local: Tensor, mesh, over: tuple, **keep) -> DTensor:
    """The sum over the mesh dims ``over`` of each rank's ``local`` (an
    all-reduce; each rank's part gets the whole gradient), laid out by
    ``keep`` on the other dims."""
    return _wrap(local, mesh, partial=over, **keep).redistribute(
        mesh, _layout(mesh.ndim, **keep))


def _grad_summed(local: Tensor, mesh, over: tuple) -> Tensor:
    """``local`` as it is, its gradient summed over the mesh dims ``over``
    (an all-reduce in the backward pass): each of those ranks computes a
    share of it.  (The DTensor around it moves nothing on the other dims.)"""
    return _wrap(local, mesh).to_local(grad_placements=_layout(mesh.ndim, partial=over))


def _moe_apply_mesh(p: Params, x: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """``moe_apply`` over the mesh that ``x`` or the weights lie on.

    Each rank works on its own tensors: the rows of ``x`` it holds (those
    mesh dims are ``rows``; every other mesh dim is gathered) and the
    experts its weights hold (dim 0 of ``gate`` / ``up`` / ``down``, sharded
    over the mesh dims ``ex``).  A rank's combine reads only its own
    experts, so the gradients it gives its routing weights and tokens are
    shares of a sum over ``ex``: those are summed (in f32) before the
    unsharded layer's bf16 casts round them.  The weights' gradients are
    shares of a sum over ``rows``, reduced back into their own layout.  The
    collectives: the router and expert weights gathered but for E (ZeRO-3),
    at decode the (B, K) ids gathered and the expert inputs summed over
    ``rows``, the combine's sums over ``ex``, the loss's fractions over
    ``rows``; in the backward pass their transposes and the two sums over
    ``ex``."""
    policy = cfg.policy
    b, s, d = x.shape
    e = cfg.moe_experts
    mesh = next(t.device_mesh for t in (x, p["gate"], p["up"], p["down"], p["router"]["w"])
                if isinstance(t, DTensor))
    n = mesh.ndim

    def on_mesh(t):  # a plain tensor: the same on every rank
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, [Replicate()] * n, run_check=False)

    x, router_w, w_gate, w_up, w_down = (on_mesh(t) for t in (
        x, p["router"]["w"], p["gate"], p["up"], p["down"]))
    ex = tuple(i for i, pl in enumerate(w_gate.placements) if pl == Shard(0))
    for w in (w_up, w_down):
        if tuple(i for i, pl in enumerate(w.placements) if pl == Shard(0)) != ex:
            raise ValueError("the expert weights shard their experts over different mesh dims")
    rows = tuple(i for i, pl in enumerate(x.placements) if pl == Shard(0) and i not in ex)
    coord = mesh.get_coordinate()
    decode = s == 1
    gs = _group_size(s, cfg)
    capacity = capacity_for(b if decode else gs, cfg)

    # this rank's rows and experts
    x_loc = x.redistribute(mesh, _layout(n, shard0=rows)).to_local()
    b_loc = x_loc.shape[0]
    r0 = shard_slices((b,), _layout(n, shard0=rows), mesh.shape, coord)[0].start
    e_sl = shard_slices((e,), _layout(n, shard0=ex), mesh.shape, coord)[0]
    e0, e_loc = e_sl.start, e_sl.stop - e_sl.start

    def gathered(w, keep: tuple) -> Tensor:
        """``w`` whole but over the mesh dims ``keep`` (ZeRO-3's regather);
        each rank's gradient is its rows' share."""
        return w.redistribute(mesh, _layout(n, shard0=keep)).to_local(
            grad_placements=_layout(n, shard0=keep, partial=rows))

    xg = x_loc.reshape(1, b_loc, d) if decode else x_loc.reshape(b_loc * (s // gs), gs, d)
    weights, ids, probs = _route(xg, gathered(router_w, ()), cfg)
    weights = _grad_summed(weights, mesh, ex)

    # load-balance auxiliary loss: the fractions' means over every group
    n_rows = 1
    for i in rows:
        n_rows *= mesh.shape[i]
    frac = torch.stack([_one_hot(ids[..., 0], e).to(torch.float32).mean(dim=(0, 1)),
                        probs.mean(dim=(0, 1))])
    frac = _summed(frac, mesh, rows) / n_rows
    aux = e * torch.sum(frac[0] * frac[1])

    if decode and rows:  # one group over the whole batch: count over every row
        ids_all = _wrap(ids[0], mesh, shard0=rows).full_tensor()
        slot = _slots(ids_all[None], e, capacity)[:, r0:r0 + b_loc]
    else:
        slot = _slots(ids, e, capacity)
    combine = _kept_weights(slot, weights, e * capacity)
    lo = e0 * capacity
    mine = (slot >= lo) & (slot < lo + e_loc * capacity)
    slot = torch.where(mine, slot - lo, torch.full_like(slot, e_loc * capacity))

    tokens = xg.to(torch.bfloat16).to(torch.float32)
    xin = _scatter_tokens(_grad_summed(tokens, mesh, ex), slot, e_loc, capacity)
    if decode and rows:  # each rank filled its own rows' slots of the one group
        xin = _summed(xin, mesh, rows, shard1=ex).to_local(
            grad_placements=_layout(n, shard1=ex, partial=rows))
    h_gate = pein("gecd,edf->gecf", xin, gathered(w_gate, ex), "moe_expert", policy)
    h_up = pein("gecd,edf->gecf", xin, gathered(w_up, ex), "moe_expert", policy)
    h = F.silu(h_gate) * h_up
    out_e = pein("gecf,efd->gecd", h, gathered(w_down, ex), "moe_expert", policy)
    part = _combine_sum(out_e, slot, combine).reshape(b_loc, s, d)
    out = _summed(part, mesh, ex, shard0=rows).to(torch.bfloat16).to(torch.float32)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], x, policy)
    return out, aux
