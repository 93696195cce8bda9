"""Wrapper, plain version and launch path of the decode-attention kernel.

The CUDA kernel (``csrc/decode_attention.cu``) replaces no TPU kernel: the
reference's attention is plain limb algebra, a chunk loop of limb einsums
over the KV cache.  The port ran that loop as it is, and at decode it took
most of the step (PERF.md); the kernel computes the same scores and values,
at the precision of their modes, in one pass over the bf16 cache.

``chunked_attention`` is that loop: online softmax over the KV cache in
chunks, its two contractions given as functions.  ``models.layers``
``flash_attention`` runs it with its policy-routed einsums for every call
the kernel does not take, and ``decode_attention_plain`` — the kernel's
plain version — runs it with the limb einsums at the two static modes.
``decode_attention`` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors.  A site's mode is a static f32-ladder
``Mode`` or, where an adaptive step binds it at run time, an int32 device
scalar that the kernel reads (the plain version selects on the device, as
``core.rmpm.mp_einsum_runtime`` does).

The two differ only in the order of f32 sums (over the head dim, over the
cache) and in where the softmax's max is taken before p is split into
limbs: the kernel takes each 256-column partition's max, the loop each
chunk's running max.  ``held_to_plain`` holds a kernel result to its plain
version within what those differences allow.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import oprecord
from repro_torch.core.precision import F32_MODES, MODE_LIMBS, Mode
from repro_torch.core.rmpm import mp_einsum, mp_einsum_runtime
from repro_torch.distributed.sharding import split_dim
from repro_torch.kernels import build

Tensor = torch.Tensor

_ROUNDING_CODE = {"trunc": 0, "grte": 1, "rne": 2}
#: the kernel's limits: query heads a KV head, head dim (a multiple of 16)
MAX_GROUP = 16
MAX_HEAD_DIM = 256
#: cache columns one thread block covers (``DA_PART`` in the source)
PARTITION = 256

QK_EQ = "bqhgd,bkhd->bhgqk"
AV_EQ = "bhgqk,bkhd->bhgqd"


def _dequant_chunk(x: Tensor, scale: Tensor | None) -> Tensor:
    if scale is None:
        return x.to(torch.float32)
    return x.to(torch.float32) * scale


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, scores, values, *, causal: bool = True,
                      window: int = 0, q_offset: Tensor | int = 0,
                      kv_len: Tensor | int | None = None, kv_positions: Tensor | None = None,
                      k_scale: Tensor | None = None, v_scale: Tensor | None = None,
                      chunk: int = 1024) -> Tensor:
    """Online-softmax attention, KV walked in chunks (a Python loop); the
    arguments as ``models.layers.flash_attention`` takes them.  ``scores(q,
    k)`` contracts ``QK_EQ`` and ``values(p, v)`` ``AV_EQ``."""
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
            kv_positions < kv_len, kv_positions,
            torch.full_like(kv_positions, -1))

    qg = split_dim(q, 2, hkv, g).to(torch.float32) * (hd**-0.5)
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
        s = scores(qg, kt)  # (B,Hkv,G,Sq,C)
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
        pv = values(p, vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(lse, min=1e-30)[..., None]
    # (B,Hkv,G,Sq,hd) -> (B,Sq,Hq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)


def decode_attention_plain(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor, *,
                           qk_mode: Mode | Tensor, av_mode: Mode | Tensor,
                           rounding: str = "rne", causal: bool = True, window: int = 0,
                           chunk: int = 1024) -> Tensor:
    """Plain version of the kernel: ``chunked_attention`` with the limb
    einsums at the two modes (what ``flash_attention`` runs at those modes,
    a device scalar's selected on the device)."""
    def contract(eq: str, mode: Mode | Tensor):
        if isinstance(mode, Tensor):
            return lambda a, b: mp_einsum_runtime(eq, a, b, mode, rounding=rounding,
                                                  device=a.device)
        return lambda a, b: mp_einsum(eq, a, b, mode, rounding=rounding, device=a.device)

    return chunked_attention(q, k, v, contract(QK_EQ, qk_mode), contract(AV_EQ, av_mode),
                             causal=causal, window=window, q_offset=q_pos,
                             kv_positions=kv_pos, chunk=chunk)


def _probs_f64(q: Tensor, k: Tensor, q_pos: Tensor, kv_pos: Tensor, causal: bool,
               window: int) -> Tensor:
    """The softmax of the decode scores in float64, (B, Hkv, G, S)."""
    b, _, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, hkv, hq // hkv, hd) * hd**-0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.double())
    kvp = kv_pos if kv_pos.dim() == 2 else kv_pos[None].expand(b, -1)
    qp = q_pos.reshape(b, 1)
    valid = kvp >= 0
    if causal:
        valid = valid & (kvp <= qp)
    if window:
        valid = valid & (kvp > qp - window)
    return torch.softmax(s.masked_fill(~valid[:, None, None], -float("inf")), dim=-1)


def attention_f64(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor, *,
                  causal: bool = True, window: int = 0) -> tuple[Tensor, Tensor]:
    """The decode attention in float64 with no limbs, the yardstick of
    ``held_to_plain``, and each output element's p-weighted mean of |v|
    (the scale of what rounding p can move it by): (B, 1, Hq, hd) each."""
    p = _probs_f64(q, k, q_pos, kv_pos, causal, window)
    vd = v.double()
    out = torch.einsum("bhgk,bkhd->bhgd", p, vd)
    wabs = torch.einsum("bhgk,bkhd->bhgd", p, vd.abs())
    return out.reshape(q.shape), wabs.reshape(q.shape)


def drop_top_key(q: Tensor, k: Tensor, q_pos: Tensor, kv_pos: Tensor, *, causal: bool = True,
                 window: int = 0) -> Tensor:
    """(B, S) positions with each row's most attended key marked empty: a
    planted fault (one key too few) that ``held_to_plain`` has to refuse."""
    top = _probs_f64(q, k, q_pos, kv_pos, causal, window).amax(dim=(1, 2)).argmax(dim=-1)
    b = q.shape[0]
    out = (kv_pos if kv_pos.dim() == 2 else kv_pos[None].expand(b, -1)).clone()
    out[torch.arange(b, device=out.device), top] = -1
    return out


def held_to_plain(got: Tensor, plain: Tensor, exact: Tensor, wabs: Tensor, *, qk_mode: Mode,
                  av_mode: Mode, rounding: str = "rne") -> dict:
    """Whether a kernel result ``got`` holds to its plain version ``plain``
    at the same modes, given ``attention_f64``'s ``exact`` and ``wabs``;
    the readings beside their limits.

    (a) Each element: |got - plain| <= (2 u + 2^-16) W, W its p-weighted
    mean |v|.  The two split p into the attn_av mode's limbs against other
    maxima (a 256-column partition's, a 1,024-row chunk's running one), so
    each p may carry another rounding of its last limb, at most u of it on
    either side (u = 2^(-8 lv), 2^(-7 lv) under truncation); the output's
    denominator sums p unsplit on both sides.  2^-16 of W holds the f32
    sums taken in other orders (over hd, over the cache).
    (b) As accurate as the plain version, no more and no less: the RMS
    error against ``exact`` at most three times the plain version's (plus
    2^-24 of W's RMS, an f32 rounding), and below the ladder's top at least
    half of it.  Both split q into the same limbs, so their errors share
    the scores' part, and a mode's error is 2^-8 of the one below it (M24's
    about a fifteenth of M16's, at f32's own level), so a result at a
    neighbouring mode falls outside (b), and one over a key too few
    outside (a)."""
    lv = MODE_LIMBS[av_mode]
    u = 2.0 ** (-(7 if rounding == "trunc" else 8) * lv)
    diff = (got.double() - plain.double()).abs()
    ratio = float((diff / ((2 * u + 2.0**-16) * wabs)).nan_to_num(0.0).max())
    err = float((got.double() - exact).pow(2).mean().sqrt())
    err_plain = float((plain.double() - exact).pow(2).mean().sqrt())
    low = 0.5 * err_plain if max(qk_mode, av_mode) < F32_MODES[-1] else 0.0
    high = 3.0 * err_plain + 2.0**-24 * float(wabs.pow(2).mean().sqrt())
    return {"max_err_over_bound": ratio, "rms_err": err, "rms_err_plain": err_plain,
            "rms_err_limits": [low, high], "ok": ratio <= 1.0 and low <= err <= high}


def kernel_takes_kv(x: Tensor) -> bool:
    """Whether a (B, S, Hkv, hd) K or V is laid out as the kernel reads it:
    bf16, each row's heads dense, batch and row strides and the base pointer
    on 16 bytes (a whole cache, or a paged cache's gathered view)."""
    return (x.dtype == torch.bfloat16 and x.stride(3) == 1 and x.stride(2) == x.shape[3]
            and x.stride(1) % 8 == 0 and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0)


def _check(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor,
           lq: int, lv: int, rounding: str) -> None:
    b, sq, hq, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} are not (B, 1, Hq, hd) and (B, S, Hkv, hd)")
    hkv = k.shape[2]
    if sq != 1 or hq % hkv or not 1 <= hq // hkv <= MAX_GROUP:
        raise ValueError(f"decode_attention takes one query a row and at most {MAX_GROUP} "
                         f"query heads a KV head, got q {tuple(q.shape)}, {hkv} KV heads")
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention takes a head dim that is a multiple of 16 up "
                         f"to {MAX_HEAD_DIM}, got {hd}")
    if not (kernel_takes_kv(k) and kernel_takes_kv(v)):
        raise ValueError("decode_attention takes bf16 K and V with dense heads and 16-byte "
                         f"strides, got {k.dtype} {tuple(k.stride())}, "
                         f"{v.dtype} {tuple(v.stride())}")
    if q_pos.shape != (b,) or kv_pos.shape not in ((k.shape[1],), (b, k.shape[1])):
        raise ValueError(f"decode_attention: positions {tuple(q_pos.shape)} and "
                         f"{tuple(kv_pos.shape)} for {b} rows of {k.shape[1]} columns")
    if q_pos.is_floating_point() or kv_pos.is_floating_point():
        raise ValueError("decode_attention takes integer positions")
    if not (1 <= lq <= 3 and 1 <= lv <= 3) or rounding not in _ROUNDING_CODE:
        raise ValueError(f"decode_attention: {lq} and {lv} limbs, rounding {rounding!r}")
    devices = {t.device for t in (q, k, v, q_pos, kv_pos)}
    if len(devices) != 1 or not q.is_cuda:
        raise ValueError(f"decode_attention kernel takes tensors on one CUDA device, "
                         f"got {sorted(map(str, devices))}")


def _limbs(mode: Mode | Tensor) -> int:
    """A static mode's limbs; a bound mode's at most (the ladder's top)."""
    if isinstance(mode, Tensor):
        if mode.numel() != 1 or mode.is_floating_point() or mode.is_complex():
            raise ValueError(f"decode_attention takes a bound mode as one integer, got "
                             f"{mode.dtype} {tuple(mode.shape)}")
        return MODE_LIMBS[F32_MODES[-1]]
    if mode not in F32_MODES:
        raise ValueError(f"decode_attention takes f32-ladder modes, got {mode!r}")
    return MODE_LIMBS[mode]


def _launch(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor,
            qk_mode: Mode | Tensor, av_mode: Mode | Tensor, rounding: str, causal: bool,
            window: int) -> Tensor:
    lq, lv = _limbs(qk_mode), _limbs(av_mode)
    _check(q, k, v, q_pos, kv_pos, lq, lv, rounding)
    b, _, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q = q.to(torch.float32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    # a bound mode as an int32 scalar on q's device (the kernel reads it)
    modes = [m.reshape(()).to(device=q.device, dtype=torch.int32)
             if isinstance(m, Tensor) else None for m in (qk_mode, av_mode)]
    n_parts = -(-s // PARTITION)
    ws = torch.empty(b * hkv * n_parts * g * (hd + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b, 1, hq, hd), dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        build.prepare_device(lib)
        code = lib.rmpm_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), q_pos.data_ptr(), kv_pos.data_ptr(),
            kv_pos.stride(0) if kv_pos.dim() == 2 else 0, ws.data_ptr(), out.data_ptr(),
            *(None if m is None else m.data_ptr() for m in modes), b, s, hkv, g, hd, lq, lv, _ROUNDING_CODE[rounding], int(causal), int(window),
            ctypes.c_float(hd**-0.5), build.current_stream_ptr())
    build.check_launch(lib, code, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor, *,
                     qk_mode: Mode | Tensor, av_mode: Mode | Tensor, rounding: str = "rne",
                     causal: bool = True, window: int = 0, chunk: int = 1024) -> Tensor:
    """Attention of one query a row, q (B, 1, Hq, hd) f32 after RoPE and
    unscaled, over a bf16 KV cache k, v (B, S, Hkv, hd): the query of row
    ``b`` sits at position ``q_pos[b]``, the cache's columns at ``kv_pos``
    ((S,) or (B, S); -1 marks an empty column).  ``qk_mode`` and ``av_mode``
    are the modes of the scores and the values: f32-ladder ``Mode``s, or
    integer device scalars bound at run time (clamped to the ladder as
    ``core.rmpm._mode_select`` clamps).  Returns (B, 1, Hq, hd) f32.  For
    CUDA tensors the kernel's two launches (``chunk`` is not read), for CPU
    tensors ``decode_attention_plain``.  Raises under autograd
    (``build.refuse_autograd``)."""
    build.refuse_autograd("decode_attention", q, k, v)
    lq, lv = _limbs(qk_mode), _limbs(av_mode)

    def run():
        if q.is_cuda:
            return _launch(q, k, v, q_pos, kv_pos, qk_mode, av_mode, rounding, causal, window)
        return decode_attention_plain(q, k, v, q_pos, kv_pos, qk_mode=qk_mode,
                                      av_mode=av_mode, rounding=rounding, causal=causal,
                                      window=window, chunk=chunk)

    if oprecord.ACTIVE is None:
        return run()
    b, _, hq, hd = q.shape
    s = k.shape[1]
    # the retained limb products of every (query head, key) pair (a bound
    # mode's at most), and one read of q, K, V and the positions and one
    # write of the output
    flops = 2.0 * b * hq * s * hd * (lq + lv)
    nbytes = float(2 * q.numel() * 4 + 2 * k.numel() * k.element_size()
                   + (q_pos.numel() + kv_pos.numel()) * 4)
    return oprecord.run_kernel("decode_attention", run, (q, k, v, q_pos, kv_pos),
                               flops=flops, nbytes=nbytes, dtype=torch.float32)
