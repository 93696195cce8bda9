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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    g, t, k = ids.shape
    onehot = _one_hot(ids, e)  # (G, T, K, E)
    flat = onehot.transpose(1, 2).reshape(g, k * t, e)  # k-major
    pos = (torch.cumsum(flat, dim=1) - 1).reshape(g, k, t, e).transpose(1, 2)
    pos = torch.gather(pos, -1, ids.long()[..., None])[..., 0]  # (G, T, K)
    keep = pos < capacity
    slot = torch.where(keep, ids.long() * capacity + pos, torch.full_like(pos, e * capacity))
    combine = torch.where(keep, weights.to(torch.bfloat16).to(torch.float32),
                          torch.zeros_like(weights))
    return slot.long(), combine


def _gather_tokens(xg: Tensor, slot: Tensor, e: int, capacity: int) -> Tensor:
    """(G, T, D) tokens -> (G, E, C, D) expert inputs, rounded to bf16 and
    back (the reference contracts its bf16 one-hot dispatch with the bf16
    tokens); empty slots are 0.  A dropped assignment writes the extra slot
    ``e * capacity``, which is cut off."""
    g, t, d = xg.shape
    k = slot.shape[-1]
    src = xg.to(torch.bfloat16).to(torch.float32)[:, :, None, :].expand(g, t, k, d)
    xin = torch.zeros((g, e * capacity + 1, d), dtype=torch.float32, device=xg.device)
    xin.scatter_(1, slot.reshape(g, t * k, 1).expand(g, t * k, d), src.reshape(g, t * k, d))
    return xin[:, :-1].reshape(g, e, capacity, d)


def _combine(out_e: Tensor, slot: Tensor, combine: Tensor) -> Tensor:
    """(G, E, C, D) expert outputs -> (G, T, D): each token's kept outputs,
    rounded to bf16, times its bf16 combine weights, summed in f32 in
    ascending expert order and rounded once to bf16 (then to f32) — the
    reference's bf16 combine einsum with its f32 accumulation."""
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
    return acc.to(torch.bfloat16).to(torch.float32)


def capacity_for(t: int, cfg) -> int:
    """Expert slots per routing group of ``t`` tokens (the reference's
    integer arithmetic)."""
    k, e = cfg.moe_top_k, cfg.moe_experts
    return max(1, int(-(-t * k // e) * cfg.moe_capacity_factor))


def moe_apply(p: Params, x: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    policy = cfg.policy
    b, s, d = x.shape
    e = cfg.moe_experts
    if s == 1:  # decode: group over the batch
        xg = x.reshape(1, b, d)
        t = b
    else:
        gs = min(cfg.moe_group_size, s)
        if s % gs:
            raise ValueError(
                f"MoE routing groups of {gs} tokens do not divide a sequence of {s} "
                f"(moe_group_size={cfg.moe_group_size})")
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
