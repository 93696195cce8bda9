"""Shared layers (dense family).  Every contraction routes through the RMPM
engine (C1): the paper's multi-precision multiplier is the only multiplier
in the system.

PyTorch idiom: plain functions on tensors and dicts of tensors.  All cache
updates are OUT OF PLACE (clone + indexed write), so a state value is never
mutated by a step: the masked step's "inactive rows keep their exact state"
and the probe's "state discarded" both hold by construction.  Weights keep
the reference's ``(d_in, d_out)`` layout and are used as ``x @ w``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.adapt.runtime_policy import runtime_mode_for
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.precision import F32_MODES, DoubleF32
from repro_torch.core.rmpm import mp_einsum, mp_einsum_runtime, mp_matmul_runtime
from repro_torch.device import backend_of
from repro_torch.plan import execute, plan_matmul

Tensor = torch.Tensor
Params = dict[str, Any]

# ---------------------------------------------------------------------------
# Policy-routed contractions
# ---------------------------------------------------------------------------


def pmm(x: Tensor, w: Tensor, op: str, policy: PrecisionPolicy) -> Tensor:
    """Policy-routed matmul: the op-class name selects the precision mode
    (the paper's application-program-driven mode-select bits), the planner
    (repro_torch.plan) selects Strassen depth and — when
    ``policy.impl='auto'`` — the execution impl.  Plans are cached per static
    shape, so a layer loop plans each distinct GEMM once.

    When the call-site is bound to a runtime mode (repro_torch.adapt's
    ``bind_modes``, installed by the adaptive serve step), the plan's static
    mode becomes merely the initial condition.  Tile-eligible plans
    (``Plan.tile_eligible``: pallas-class f32 plans) take the mode-map
    kernel — the mode becomes a uniform per-tile map read inside ONE launch,
    bit-identical to the limb kernel at that mode; other impls branch on the
    host over the static paths.  Only f32-ladder plans are switchable;
    DF32/Strassen plans keep their static path.
    """
    plan = plan_matmul(
        tuple(x.shape),
        tuple(w.shape),
        mode=policy.mode_for(op),
        impl=None if policy.impl == "auto" else policy.impl,
        rounding=policy.rounding,
        max_depth=policy.max_strassen_depth,
        backend=backend_of(x.device),
    )
    rt_mode = runtime_mode_for(op)
    if (
        rt_mode is not None
        and plan.mode in F32_MODES
        and plan.dtype == "float32"
        and not isinstance(x, DoubleF32)
    ):
        # runtime reconfiguration wins over the plan's Strassen depth; mode
        # tables hold concrete modes, so the AUTO operand probe is skipped.
        # 'native' cannot express a mode switch; xla keeps the host branch
        impl = "tile" if plan.tile_eligible else "xla"
        return mp_matmul_runtime(
            x, w, rt_mode, rounding=plan.rounding,
            impl=impl, block=plan.block, allow_auto=False, device=x.device,
        )
    return execute(plan, x, w)


def pein(eq: str, a: Tensor, b: Tensor, op: str, policy: PrecisionPolicy) -> Tensor:
    mode = policy.mode_for(op)
    rt_mode = runtime_mode_for(op)
    if (
        rt_mode is not None
        and mode in F32_MODES
        and not isinstance(a, DoubleF32)
        and not isinstance(b, DoubleF32)
    ):
        # bound sites always run the limb engine: a 'native' policy impl
        # (plain f32, mode-blind) cannot express a mode switch
        impl = policy.impl if policy.impl in ("xla", "pallas", "tile") else "xla"
        return mp_einsum_runtime(
            eq, a, b, rt_mode, rounding=policy.rounding, impl=impl,
            device=a.device,
        )
    return mp_einsum(
        eq, a, b, mode, rounding=policy.rounding, impl=policy.impl,
        device=a.device,
    )


def plinear(x: Tensor, p: Params, op: str, policy: PrecisionPolicy) -> Tensor:
    out = pmm(x, p["w"], op, policy)
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, bias: bool = False,
               scale: float | None = None, *, layers: int | None = None) -> Params:
    """``layers=L`` initializes L layers stacked along a leading axis (the
    layout the reference's scanned stacks use)."""
    std = scale if scale is not None else (2.0 / (d_in + d_out)) ** 0.5
    lead = () if layers is None else (layers,)
    dev = gen.device
    p = {"w": torch.randn((*lead, d_in, d_out), generator=gen, device=dev,
                          dtype=torch.float32) * std}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=torch.float32, device=dev)
    return p


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        ang = positions[:, None].to(torch.float32) * freqs[None, :]  # (S, half)
        ang = ang[None, :, None, :]  # (1, S, 1, half)
    else:
        ang = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache (bf16 or block-scaled int8 — the paper's precision lever applied
# to decode memory)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    k: Tensor  # (B, Smax, Hkv, hd)  bf16 or int8
    v: Tensor
    k_scale: Tensor | None  # (B, Smax, Hkv, 1) f32 when int8
    v_scale: Tensor | None
    pos: Tensor  # (Smax,) int32 — global position stored in each slot (-1 empty)
    # per-slot layout (continuous batching): pos is (B, Smax)
    length: Tensor  # scalar int32 — total tokens ever appended; (B,) per-slot


def kv_cache_init(batch: int, s_max: int, n_kv: int, hd: int, dtype: str,
                  per_slot: bool = False, device="cpu") -> KVCache:
    if per_slot:
        pos = torch.full((batch, s_max), -1, dtype=torch.int32, device=device)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
    else:
        pos = torch.full((s_max,), -1, dtype=torch.int32, device=device)
        length = torch.zeros((), dtype=torch.int32, device=device)

    def z(dt):
        return torch.zeros((batch, s_max, n_kv, hd), dtype=dt, device=device)

    if dtype == "int8":
        def s():
            return torch.zeros((batch, s_max, n_kv, 1), dtype=torch.float32, device=device)

        return KVCache(z(torch.int8), z(torch.int8), s(), s(), pos, length)
    return KVCache(z(torch.bfloat16), z(torch.bfloat16), None, None, pos, length)


def _quant_rows(x: Tensor) -> tuple[Tensor, Tensor]:
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _put(buf: Tensor, idx: tuple, vals: Tensor) -> Tensor:
    """Out-of-place indexed write (the ``dynamic_update_slice`` analogue)."""
    out = buf.clone()
    out[idx] = vals.to(buf.dtype)
    return out


def kv_cache_append(cache: KVCache, k_new: Tensor, v_new: Tensor) -> KVCache:
    """Append (B, S_new, Hkv, hd) f32 at slot length % capacity (ring buffer
    for sliding-window caches; plain append while length < capacity).
    Multi-token appends must not straddle the wrap point (prefill sizes the
    cache to the prompt, so wrap only occurs in 1-token decode steps).
    """
    cap = cache.k.shape[1]
    s_new = k_new.shape[1]
    dev = cache.k.device
    if s_new > cap:
        # prefill longer than the (sliding-window) cache: keep the tail only
        drop = s_new - cap
        k_new = k_new[:, drop:]
        v_new = v_new[:, drop:]
        pos = (cache.length + drop
               + torch.arange(cap, dtype=torch.int32, device=dev)).to(torch.int32)
        total = cache.length + s_new
        s_new = cap
        cols = torch.arange(cap, device=dev)
    else:
        slot = torch.remainder(cache.length, cap)
        cols = (slot + torch.arange(s_new, dtype=torch.int32, device=dev)).long()
        pos = _put(cache.pos, (cols,),
                   cache.length + torch.arange(s_new, dtype=torch.int32, device=dev))
        total = cache.length + s_new
    idx = (slice(None), cols)
    if cache.k_scale is not None:
        kq, ks = _quant_rows(k_new)
        vq, vs = _quant_rows(v_new)
        return KVCache(_put(cache.k, idx, kq), _put(cache.v, idx, vq),
                       _put(cache.k_scale, idx, ks), _put(cache.v_scale, idx, vs),
                       pos, total.to(torch.int32))
    return KVCache(_put(cache.k, idx, k_new), _put(cache.v, idx, v_new),
                   None, None, pos, total.to(torch.int32))


def kv_cache_append_slots(cache: KVCache, k_new: Tensor, v_new: Tensor) -> KVCache:
    """Per-slot append for continuous batching: ``cache.length`` is (B,) and
    ``cache.pos`` is (B, Smax), so every slot writes at its *own* ring offset
    — slots at different sequence lengths share one decode step.  The
    reference maps a single-row append over the batch; here the batch
    dimension is written out as one indexed write per buffer."""
    cap = cache.k.shape[1]
    b, s_new = k_new.shape[:2]
    dev = cache.k.device
    ar = torch.arange
    if s_new > cap:
        drop = s_new - cap
        k_new, v_new = k_new[:, drop:], v_new[:, drop:]
        pos = (cache.length[:, None] + drop
               + ar(cap, dtype=torch.int32, device=dev)[None, :]).to(torch.int32)
        total = cache.length + s_new
        cols = ar(cap, device=dev)[None, :].expand(b, cap)
    else:
        slot = torch.remainder(cache.length, cap)  # (B,)
        cols = (slot[:, None] + ar(s_new, dtype=torch.int32, device=dev)[None, :]).long()
        rows_p = ar(b, device=dev)[:, None]
        pos = _put(cache.pos, (rows_p, cols),
                   cache.length[:, None] + ar(s_new, dtype=torch.int32, device=dev)[None, :])
        total = cache.length + s_new
    idx = (ar(b, device=dev)[:, None], cols)
    if cache.k_scale is not None:
        kq, ks = _quant_rows(k_new)
        vq, vs = _quant_rows(v_new)
        return KVCache(_put(cache.k, idx, kq), _put(cache.v, idx, vq),
                       _put(cache.k_scale, idx, ks), _put(cache.v_scale, idx, vs),
                       pos, total.to(torch.int32))
    return KVCache(_put(cache.k, idx, k_new), _put(cache.v, idx, v_new),
                   None, None, pos, total.to(torch.int32))


def kv_append(cache: KVCache, k_new: Tensor, v_new: Tensor) -> KVCache:
    """Layout dispatch for cache appends: dense per-slot nodes ((B,)
    lengths) ring-append per row, shared-length nodes append at one scalar
    offset.  (The paged branch of the reference is not ported yet.)"""
    if cache.length.dim() == 1:
        return kv_cache_append_slots(cache, k_new, v_new)
    return kv_cache_append(cache, k_new, v_new)


def kv_view(cache: KVCache):
    """The (k, v, k_scale, v_scale) tensors attention reads for this node."""
    return cache.k, cache.v, cache.k_scale, cache.v_scale


def _dequant_chunk(x: Tensor, scale: Tensor | None) -> Tensor:
    if scale is None:
        return x.to(torch.float32)
    return x.to(torch.float32) * scale


# ---------------------------------------------------------------------------
# Flash attention (chunked-KV online softmax — never materializes S x S)
# ---------------------------------------------------------------------------


def flash_attention(
    q: Tensor,  # (B, Sq, Hq, hd) f32
    k: Tensor,  # (B, Skv, Hkv, hd) f32/bf16/int8
    v: Tensor,
    policy: PrecisionPolicy,
    *,
    causal: bool = True,
    window: int = 0,  # sliding window (0 = unbounded)
    q_offset: Tensor | int = 0,  # global position of q[0] (decode); (B,) per-slot
    kv_len: Tensor | int | None = None,  # valid cache length
    kv_positions: Tensor | None = None,  # (Skv,) or (B, Skv) global positions
    k_scale: Tensor | None = None,
    v_scale: Tensor | None = None,
    chunk: int = 1024,
) -> Tensor:
    """Online-softmax attention, KV walked in chunks (a Python loop).

    GQA: Hq = Hkv * G.  Scores and attention-value products go through the
    RMPM engine ('attn_qk' / 'attn_av' op classes) — which is why no fused
    attention operator can stand in for this function.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    g = hq // hkv
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        def padded(x):
            return F.pad(x, (0, 0, 0, 0, 0, pad))

        k, v = padded(k), padded(v)
        if k_scale is not None:
            k_scale, v_scale = padded(k_scale), padded(v_scale)
        if kv_positions is not None:
            kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    if kv_len is None:
        kv_len = skv
    if kv_positions is None:
        kv_positions = torch.arange(n_chunks * chunk, dtype=torch.int32, device=dev)
        kv_positions = torch.where(
            kv_positions < torch.as_tensor(kv_len, device=dev), kv_positions,
            torch.full_like(kv_positions, -1))

    qg = q.reshape(b, sq, hkv, g, hd).to(torch.float32) * (hd**-0.5)
    q_offset = torch.as_tensor(q_offset, device=dev)
    # per-slot decode: q_offset (B,) -> q_pos (B, Sq); shared: (Sq,)
    q_pos = (q_offset[:, None] if q_offset.dim() else q_offset) + torch.arange(sq, device=dev)
    q_b = q_pos if q_pos.dim() == 2 else q_pos[None, :]  # (B|1, Sq)

    m = torch.full((b, hkv, g, sq), -float("inf"), dtype=torch.float32, device=dev)
    lse = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        kt = _dequant_chunk(k[:, sl], k_scale[:, sl] if k_scale is not None else None)
        vt = _dequant_chunk(v[:, sl], v_scale[:, sl] if v_scale is not None else None)
        s = pein("bqhgd,bkhd->bhgqk", qg, kt, "attn_qk", policy)  # (B,Hkv,G,Sq,C)
        kv_pos = kv_positions[..., sl]
        # broadcast to (B|1, Sq|1, C) so per-slot positions mask per batch row
        kv_b = kv_pos if kv_pos.dim() == 2 else kv_pos[None, :]  # (B|1, C)
        valid = kv_b[:, None, :] >= 0
        if causal:
            valid = valid & (kv_b[:, None, :] <= q_b[:, :, None])
        if window:
            valid = valid & (kv_b[:, None, :] > q_b[:, :, None] - window)
        s = torch.where(valid[:, None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        lse = lse * alpha + p.sum(dim=-1)
        pv = pein("bhgqk,bkhd->bhgqd", p, vt, "attn_av", policy)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(lse, min=1e-30)[..., None]
    # (B,Hkv,G,Sq,hd) -> (B,Sq,Hq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)


# ---------------------------------------------------------------------------
# Attention layer (projections + rope + flash) — full-sequence and decode
# ---------------------------------------------------------------------------


def attention_init(gen: torch.Generator, cfg, *, layers: int | None = None) -> Params:
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": dense_init(gen, cfg.d_model, hq * hd, cfg.qkv_bias, layers=layers),
        "wk": dense_init(gen, cfg.d_model, hkv * hd, cfg.qkv_bias, layers=layers),
        "wv": dense_init(gen, cfg.d_model, hkv * hd, cfg.qkv_bias, layers=layers),
        "wo": dense_init(gen, hq * hd, cfg.d_model, layers=layers),
    }


def attention_apply(
    p: Params,
    x: Tensor,
    cfg,
    *,
    positions: Tensor | None = None,
    cache: KVCache | None = None,
    window: int = 0,
    causal: bool = True,
) -> tuple[Tensor, KVCache | None]:
    policy = cfg.policy
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = plinear(x, p["wq"], "qkv", policy).reshape(b, s, hq, hd)
    k = plinear(x, p["wk"], "qkv", policy).reshape(b, s, hkv, hd)
    v = plinear(x, p["wv"], "qkv", policy).reshape(b, s, hkv, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        q_offset = cache.length
        cache = kv_append(cache, k, v)
        if s > 1:
            # prefill: attend over the fresh full-length K/V (the window
            # cache may be smaller than the prompt; it keeps only the tail)
            fresh_pos = torch.arange(s, dtype=torch.int32, device=x.device)
            fresh_pos = (q_offset[:, None] if q_offset.dim() else q_offset) + fresh_pos
            out = flash_attention(
                q, k, v, policy, causal=causal, window=window,
                q_offset=q_offset, kv_positions=fresh_pos, chunk=cfg.attn_chunk,
            )
        else:
            k_read, v_read, ks_read, vs_read = kv_view(cache)
            out = flash_attention(
                q, k_read, v_read, policy, causal=causal, window=window,
                q_offset=q_offset, kv_positions=cache.pos,
                k_scale=ks_read, v_scale=vs_read, chunk=cfg.attn_chunk,
            )
    else:
        out = flash_attention(
            q, k, v, policy, causal=causal, window=window, chunk=cfg.attn_chunk
        )
    out = pmm(out.reshape(b, s, hq * hd), p["wo"]["w"], "out", policy)
    return out, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                layers: int | None = None) -> Params:
    return {
        "gate": dense_init(gen, d_model, d_ff, layers=layers),
        "up": dense_init(gen, d_model, d_ff, layers=layers),
        "down": dense_init(gen, d_ff, d_model, layers=layers),
    }


def swiglu_apply(p: Params, x: Tensor, policy: PrecisionPolicy) -> Tensor:
    g = pmm(x, p["gate"]["w"], "mlp_up", policy)
    u = pmm(x, p["up"]["w"], "mlp_up", policy)
    return pmm(F.silu(g) * u, p["down"]["w"], "mlp_down", policy)
