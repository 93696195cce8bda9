"""Cheap online error probes for the runtime adaptation loop.

The controller needs a live estimate of the numerical error the *current*
mode table inflicts.  Truth is unavailable online, so the probes compare
against the most precise runtime-switchable configuration — the mode table
shifted to its max (M24), run through the SAME decode step with different
modes bound (nothing is built).  Three signals, cheapest first:

  * :func:`logit_residual` — normalized max-abs logit deviation between a
    low-mode and reference forward, masked to active slots.  Scale-
    normalized by the reference logit spread so one SLO threshold works
    across workloads; softmax-space total variation (:func:`softmax_tv`) is
    available when the caller cares about sampling fidelity.
  * :func:`sampled_matmul_residual` — re-multiplies a row sample of one GEMM
    at ``mode`` and ``mode+1`` and reports the relative gap.
  * :class:`GradDriftProbe` — EWMA drift of the gradient norm, the training
    loop's error surrogate (loss-scale blowups and underflow both announce
    themselves as grad-norm drift long before the loss diverges).

Probe cost is budgeted by the caller (``AdaptConfig(adapt_every=N)`` probes
every N decode steps: three shadow forwards per probe).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.precision import Mode
from repro_torch.core.rmpm import mp_matmul

Tensor = torch.Tensor

_EPS = 1e-9


def logit_residual(logits_lo: Tensor, logits_ref: Tensor,
                   active: Tensor | None = None) -> Tensor:
    """max over active rows of max-abs logit deviation, normalized by the
    reference row's logit spread (population std): a scale-free
    observed-error metric.

    Args:
      logits_lo / logits_ref: (B, V) last-position logits of the probed and
        reference forwards.
      active: (B,) bool — rows currently serving a request; inactive rows
        are frozen state and carry no meaningful logits.
    """
    diff = (logits_lo - logits_ref).abs().amax(dim=-1)  # (B,)
    spread = logits_ref.std(dim=-1, unbiased=False) + _EPS
    err = diff / spread
    if active is not None:
        err = torch.where(active, err, torch.zeros_like(err))
    return err.max()


def softmax_tv(logits_lo: Tensor, logits_ref: Tensor,
               active: Tensor | None = None) -> Tensor:
    """Total-variation distance between next-token distributions (max over
    active rows) — the sampling-fidelity view of the same residual."""
    tv = 0.5 * (torch.softmax(logits_lo, dim=-1)
                - torch.softmax(logits_ref, dim=-1)).abs().sum(dim=-1)
    if active is not None:
        tv = torch.where(active, tv, torch.zeros_like(tv))
    return tv.max()


def sampled_matmul_residual(
    x: Tensor,
    w: Tensor,
    mode: Mode | int,
    *,
    sample_rows: int = 4,
    generator: torch.Generator | None = None,
    rounding: str = "rne",
) -> Tensor:
    """Relative error of ``x @ w`` at ``mode`` vs one mode up, on a row
    sample of ``x`` (the first rows, or a random sample when a ``generator``
    is given).  Returns a scalar: max-abs deviation / max-abs of the shadow
    result.  ``mode`` at the top of the f32 ladder returns 0."""
    mode = Mode(mode)
    up = Mode(min(int(mode) + 1, int(Mode.M24)))
    n = x.shape[0]
    k = min(sample_rows, n)
    if generator is None:
        rows = torch.arange(k, device=x.device)
    else:
        rows = torch.randperm(n, generator=generator)[:k].to(x.device)
    xs = x[rows]
    lo = mp_matmul(xs, w, mode, rounding=rounding, device=x.device)
    hi = mp_matmul(xs, w, up, rounding=rounding, device=x.device)
    return (lo - hi).abs().max() / (hi.abs().max() + _EPS)


@dataclasses.dataclass
class GradDriftProbe:
    """EWMA drift of the gradient norm: ``drift = |gn - ewma| / ewma``.

    Warmup steps (the first ``warmup`` observations) return 0 — the first
    steps' transients must not trigger mode shifts.
    """

    alpha: float = 0.1
    warmup: int = 3
    ewma: float = 0.0
    n: int = 0

    def update(self, grad_norm: float) -> float:
        self.n += 1
        if self.n <= self.warmup:
            self.ewma = grad_norm
            return 0.0
        drift = abs(grad_norm - self.ewma) / (self.ewma + _EPS)
        self.ewma += self.alpha * (grad_norm - self.ewma)
        return drift
