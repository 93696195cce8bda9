"""RecurrentGemma / Griffin hybrid blocks  [arXiv:2402.19427].

The port of ``src/repro/models/griffin.py``.  Residual pattern (rec, rec,
attn) repeating (1 local-attention block per 2 RG-LRU recurrent blocks).
Projections route through RMPM; the RG-LRU gate / diagonal recurrence is
elementwise (f32, technique N/A, as in the reference).

The reference runs the recurrence as a ``jax.lax.associative_scan``; here
it is a sequential f32 loop over the sequence, ``h_t = a_t * h_{t-1} +
g_t``, which is exactly the decode step's update, so a prefill and the
token-by-token decode of the same sequence agree bit for bit.  Against the
reference the association order differs (a log-depth tree there), so the
two agree to a few f32 ulps of the state, not bitwise.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import Params, causal_conv1d, dense_init, pein

Tensor = torch.Tensor

_C = 8.0  # Griffin's fixed scaling of the recurrence gate exponent


@dataclasses.dataclass
class RGLRUState:
    conv: Tensor  # (B, K-1, W)
    h: Tensor  # (B, W) recurrent hidden state


def rglru_init(gen: torch.Generator, cfg, *, layers: int | None = None) -> Params:
    """``layers=L`` stacks L blocks along a leading axis."""
    d = cfg.d_model
    w = d  # lru width = d_model (RecurrentGemma)
    lead = () if layers is None else (layers,)
    dev = gen.device
    lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=dev)
    return {
        "in_x": dense_init(gen, d, w, layers=layers),
        "in_gate": dense_init(gen, d, w, layers=layers),
        "conv_w": torch.randn((*lead, 4, w), generator=gen, device=dev,
                              dtype=torch.float32) * 0.2,
        "wa": dense_init(gen, w, w, scale=0.02, layers=layers),
        "wx": dense_init(gen, w, w, scale=0.02, layers=layers),
        # Lambda init so a = sigmoid(lam)^(c r) sits in [0.9, 0.999]
        "lam": torch.log(lin / (1 - lin)).expand(*lead, w).clone(),
        "out": dense_init(gen, w, d, layers=layers),
    }


def _logsigmoid(x: Tensor) -> Tensor:
    """``F.logsigmoid``; on a DTensor, shard by shard (it is pointwise, and
    DTensor has no rule for ``aten.log_sigmoid_forward``)."""
    if isinstance(x, DTensor):
        return DTensor.from_local(F.logsigmoid(x.to_local()), x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape, stride=x.stride())
    return F.logsigmoid(x)


def _rglru_scan(x: Tensor, r: Tensor, i: Tensor, lam: Tensor, h0: Tensor | None):
    """h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), sequentially.

    x, r, i: (B, S, W); lam: (W,).  Returns (h_seq, h_last).
    """
    log_a_base = _logsigmoid(lam)[None, None, :]  # (1,1,W), negative
    log_a = _C * r * log_a_base  # (B, S, W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x)
    h = h0
    hs = []
    for t in range(x.shape[1]):
        h = gated[:, t] if h is None else a[:, t] * h + gated[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_block_apply(p: Params, x: Tensor, cfg, state: RGLRUState | None = None
                      ) -> tuple[Tensor, RGLRUState | None]:
    """Griffin recurrent residual block body. x: (B, S, D)."""
    policy = cfg.policy
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(pein("bsd,dw->bsw", x, p["in_gate"]["w"], "mlp_up", policy),
                  approximate="tanh")
    xr = pein("bsd,dw->bsw", x, p["in_x"]["w"], "mlp_up", policy)
    conv_out, conv_state = causal_conv1d(
        xr, p["conv_w"], state.conv if state is not None else None)
    r = torch.sigmoid(pein("bsw,wv->bsv", conv_out, p["wa"]["w"], "rnn_gate", policy))
    i = torch.sigmoid(pein("bsw,wv->bsv", conv_out, p["wx"]["w"], "rnn_gate", policy))
    h, h_last = _rglru_scan(conv_out, r, i, p["lam"], state.h if state is not None else None)
    out = pein("bsw,wd->bsd", h * gate, p["out"]["w"], "mlp_down", policy)
    new_state = RGLRUState(conv=conv_state, h=h_last) if state is not None else None
    return out, new_state


def rglru_state_init(cfg, batch: int, device="cpu") -> RGLRUState:
    w = cfg.d_model
    return RGLRUState(
        conv=torch.zeros((batch, 3, w), dtype=torch.float32, device=device),
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
    )
