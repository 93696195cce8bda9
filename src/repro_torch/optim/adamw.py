"""AdamW with optional int8 block-quantized moments (the distributed-
optimization trick of the reference: int8 moments halve and halve again the
optimizer's memory) and cosine / linear schedules with warmup.

The reference's ``repro.optim.adamw`` on PyTorch tensors, operation for
operation in f32: the same schedule, clipping, moment updates and
block quantization (``torch.round`` and ``jnp.round`` both round half to
even, so ``_quant`` gives the reference's codes and scales bit for bit).
Trees are the port's nested dicts of tensors (``repro_torch.tree``).  The
update runs under ``no_grad`` and returns new tensors: ``apply_updates``
returns ``(params, state, metrics)`` and leaves its arguments as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree

Tensor = torch.Tensor

_BLOCK = 256  # quantization block (last-dim groups)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # 'cosine' | 'linear' | 'const'
    quantize_moments: bool = False


def schedule_lr(cfg: AdamWConfig, step) -> Tensor:
    """The learning rate at ``step`` (an int or an int32 tensor), an f32
    scalar on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones((), dtype=torch.float32, device=step.device)
    return cfg.lr * warm * decay


# --- int8 block quantization of moment tensors -----------------------------


def _quant(x: Tensor) -> tuple[Tensor, Tensor]:
    """Block-quantize along the LAST dim only: (..., D) -> (..., D/B, B)
    int8 codes and (..., D/B, 1) f32 scales (the reference's layout, which
    keeps every leading dim whole for sharding)."""
    d = x.shape[-1] if x.dim() else 1
    block = _BLOCK if d % _BLOCK == 0 else d
    xb = x.reshape(*x.shape[:-1], d // block, block)
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-20
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant(q: Tensor, scale: Tensor, shape) -> Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def _maybe_q(x: Tensor, on: bool):
    return _quant(x) if on else x


def _maybe_dq(m, shape, on: bool) -> Tensor:
    return _dequant(*m, shape) if on else m


def init_state(params: Any, cfg: AdamWConfig) -> dict:
    """``step`` (an int32 scalar on the params' device) and the moments
    ``m`` and ``v``, distinct zero tensors (or int8 codes and scales) per
    parameter."""
    q = cfg.quantize_moments

    def zero_q(p):
        return _maybe_q(torch.zeros_like(p, dtype=torch.float32), q)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=tree.leaves(params)[0].device),
        "m": tree.map_tree(zero_q, params),
        "v": tree.map_tree(zero_q, params),
    }


def global_norm(grads: Any) -> Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves added in
    the reference's order."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in tree.leaves(grads)]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics): ``metrics`` holds ``lr``
    and ``grad_norm`` (before clipping), f32 scalars on the device."""
    q = cfg.quantize_moments
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        # a tensor numerator: ``float / tensor`` would multiply by a reciprocal
        limit = torch.full_like(gnorm, cfg.grad_clip)
        clip = torch.clamp(limit / (gnorm + 1e-9), max=1.0)
    else:
        clip = 1.0

    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)

    leaves_p = tree.leaves(params)
    leaves_g = tree.leaves_up_to(params, grads)
    leaves_m = tree.leaves_up_to(params, state["m"])
    leaves_v = tree.leaves_up_to(params, state["v"])

    new_p, new_m, new_v = [], [], []
    for p, g, m_, v_ in zip(leaves_p, leaves_g, leaves_m, leaves_v, strict=True):
        g = g.to(torch.float32) * clip
        m = _maybe_dq(m_, p.shape, q)
        v = _maybe_dq(v_, p.shape, q)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * upd).to(p.dtype))
        new_m.append(_maybe_q(m, q))
        new_v.append(_maybe_q(v, q))

    return (
        tree.unflatten(params, new_p),
        {"step": step,
         "m": tree.unflatten(params, new_m),
         "v": tree.unflatten(params, new_v)},
        {"lr": lr, "grad_norm": gnorm},
    )
