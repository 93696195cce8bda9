"""Mamba2 / SSD (state-space duality) block  [arXiv:2405.21060].

The port of ``src/repro/models/ssm.py``.  The SSD chunked algorithm is
matmul-dominated: the intra-chunk quadratic term and the inter-chunk state
contractions route through RMPM ('ssd' op class).  The recurrent gate/decay
algebra itself is elementwise and runs in f32 — the technique is N/A to the
scan, as in the reference.

Train: chunked dual form (quadratic intra-chunk + linear inter-chunk scan).
Decode: O(1) recurrent state update per token.  Where the reference scans
with ``lax.scan`` (the inter-chunk recurrence, the per-token recurrence),
this is a Python loop over the same steps in the same order.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, causal_conv1d, dense_init, pein

Tensor = torch.Tensor


@dataclasses.dataclass
class SSMState:
    conv: Tensor  # (B, K-1, conv_channels)
    ssm: Tensor  # (B, H, P, N)


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads


def mamba2_init(gen: torch.Generator, cfg, *, layers: int | None = None) -> Params:
    """``layers=L`` stacks L blocks along a leading axis."""
    d, n = cfg.d_model, cfg.ssm_state
    d_inner, n_heads = _dims(cfg)
    lead = () if layers is None else (layers,)
    dev = gen.device
    # in_proj -> [z (gate), x, B, C, dt]
    d_proj = 2 * d_inner + 2 * n + n_heads
    conv_ch = d_inner + 2 * n  # conv over x, B, C

    def per_layer(v):
        return v.expand(*lead, *v.shape).clone()

    return {
        "in_proj": dense_init(gen, d, d_proj, layers=layers),
        "conv_w": torch.randn((*lead, cfg.ssm_conv, conv_ch), generator=gen, device=dev,
                              dtype=torch.float32) * 0.2,
        "a_log": per_layer(torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev,
                                                    dtype=torch.float32))),
        "dt_bias": torch.zeros((*lead, n_heads), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((*lead, n_heads), dtype=torch.float32, device=dev),
        "norm_scale": torch.zeros((*lead, d_inner), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_inner, d, layers=layers),
    }


def _segsum(x: Tensor) -> Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i >= j)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.full_like(out, -float("inf")))


def _ssd_chunked(xh, dt, a, bmat, cmat, cfg, h0=None):
    """SSD dual form over chunks.

    xh: (B, S, H, P); dt: (B, S, H); a: (H,) negative decay rates;
    bmat/cmat: (B, S, N).  Returns (y, final_state (B, H, P, N)).
    """
    policy = cfg.policy
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, (s, q)
    c = s // q
    xs = xh.reshape(b, c, q, h, p)
    dts = dt.reshape(b, c, q, h)
    bs = bmat.reshape(b, c, q, n)
    cs = cmat.reshape(b, c, q, n)

    da = dts * a[None, None, None, :]  # (B, C, Q, H) negative
    da_cum = torch.cumsum(da, dim=2)

    # --- intra-chunk (quadratic, matmul-heavy) ---
    l_mat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))  # (B, C, H, Q, Q)
    scores = pein("bcqn,bckn->bcqk", cs, bs, "ssd", policy)  # (B, C, Q, Q)
    gated = scores[:, :, None] * l_mat  # (B, C, H, Q, Q)
    xdt = xs * dts[..., None]  # (B, C, Q, H, P)
    y_intra = pein("bchqk,bckhp->bcqhp", gated, xdt, "ssd", policy)

    # --- chunk states ---
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # (B, C, Q, H)
    states = pein("bcqn,bcqhp->bchpn", bs, xdt * decay_to_end[..., None], "ssd",
                  policy)  # (B, C, H, P, N)

    # --- inter-chunk recurrence over C (sequential, tiny) ---
    chunk_decay = torch.exp(da_cum[:, :, -1, :])  # (B, C, H)
    carry = (h0 if h0 is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device))
    prev = []
    for ci in range(c):
        prev.append(carry)  # the state entering chunk ci
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)  # (B, C, H, P, N)

    # --- inter-chunk output ---
    decay_from_start = torch.exp(da_cum)  # (B, C, Q, H)
    c_gated = cs[:, :, :, None, :] * decay_from_start[..., None]  # (B,C,Q,H,N)
    y_inter = pein("bcqhn,bchpn->bcqhp", c_gated, prev_states, "ssd", policy)

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, carry


def mamba2_apply(p: Params, x: Tensor, cfg, state: SSMState | None = None
                 ) -> tuple[Tensor, SSMState | None]:
    """x: (B, S, d_model).  state!=None -> decode (S small, sequential), or
    the chunked form with the carried state for a multi-token prefill."""
    policy = cfg.policy
    b, s, _ = x.shape
    d_inner, n_heads = _dims(cfg)
    n = cfg.ssm_state
    proj = pein("bsd,de->bse", x, p["in_proj"]["w"], "ssm_in", policy)
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * n, n_heads], dim=-1)
    conv_out, conv_state = causal_conv1d(
        xbc, p["conv_w"], state.conv if state is not None else None)
    conv_out = F.silu(conv_out)
    xh, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xh = xh.reshape(b, s, n_heads, cfg.ssm_head_dim)
    # jax.nn.softplus is logaddexp(x, 0)
    dt_in = dt_raw + p["dt_bias"][None, None, :]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))  # (B, S, H)
    a = -torch.exp(p["a_log"])  # (H,) negative

    if state is None:
        y, _ = _ssd_chunked(xh, dt, a, bmat, cmat, cfg)
        new_state = None
    elif s > 1 and s % min(cfg.ssm_chunk, s) == 0:
        # multi-token prefill: the chunked dual form with the carried state
        y, final = _ssd_chunked(xh, dt, a, bmat, cmat, cfg, h0=state.ssm)
        new_state = SSMState(conv=conv_state, ssm=final)
    else:
        # recurrent: h = exp(dt*a) h + dt * B x ; y = C h   (per step)
        h = state.ssm
        ys = []
        for t in range(s):
            xt, dtt, bt, ct = xh[:, t], dt[:, t], bmat[:, t], cmat[:, t]
            decay = torch.exp(dtt * a[None, :])[..., None, None]
            h = h * decay + (dtt[..., None] * xt)[..., None] * bt[:, None, None, :]
            ys.append(torch.einsum("bhpn,bn->bhp", h, ct))
        y = torch.stack(ys, dim=1)  # (B, S, H, P)
        new_state = SSMState(conv=conv_state, ssm=h)

    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_inner)
    # gated RMSNorm (Mamba2)
    y = y * F.silu(z)
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * (1.0 + p["norm_scale"])
    out = pein("bse,ed->bsd", y, p["out_proj"]["w"], "ssm_out", policy)
    return out, new_state


def ssm_state_init(cfg, batch: int, device="cpu") -> SSMState:
    d_inner, n_heads = _dims(cfg)
    conv_ch = d_inner + 2 * cfg.ssm_state
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=torch.float32,
                         device=device),
        ssm=torch.zeros((batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
    )
