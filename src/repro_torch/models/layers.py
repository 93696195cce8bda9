"""Shared layers (attention, MLPs, KV caches) of every family.  Every
contraction routes through the RMPM engine (C1): the paper's
multi-precision multiplier is the only multiplier in the system.

PyTorch idiom: plain functions on tensors and dicts of tensors.  Dense
cache updates are OUT OF PLACE (clone + indexed write), so a dense state
value is never mutated by a step: the masked step's "inactive rows keep
their exact state" and the probe's "state discarded" both hold by
construction.  The paged cache's pools are the one exception: appends write
them in place (see the paged section below).  Weights keep
the reference's ``(d_in, d_out)`` layout and are used as ``x @ w``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.adapt.runtime_policy import runtime_mode_for
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.precision import F32_MODES, DoubleF32
from repro_torch.core.rmpm import mp_einsum, mp_einsum_runtime, mp_matmul_runtime
from repro_torch.device import backend_of
from repro_torch.distributed.sharding import BATCH_AXES, constrain, contiguous_stride, split_dim
from repro_torch.kernels.decode_attention.ops import (
    AV_EQ, MAX_GROUP, MAX_HEAD_DIM, QK_EQ, chunked_attention, decode_attention, kernel_takes_kv)
from repro_torch.obs.device import device_span
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
    bit-identical to the limb kernel at that mode; other impls branch on a
    host int over the static paths, or select among them on the device for
    a device scalar (what the engine's captured steps bind).  Only f32-ladder plans are switchable;
    DF32/Strassen plans keep their static path.

    The call is a device span named ``op`` (repro_torch.obs.device), timed
    only while a recording is open.
    """
    with device_span(op):
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
    """Policy-routed einsum (``pmm``'s counterpart for any contraction);
    a device span named ``op``, as ``pmm`` is."""
    with device_span(op):
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
    if isinstance(buf, DTensor):
        return _put_local(buf, idx, vals)
    out = buf.clone()
    out[idx] = vals.to(buf.dtype)
    return out


def _put_local(buf: DTensor, idx: tuple, vals: Tensor) -> DTensor:
    """``_put`` of a DTensor whose indexed dims are whole on every rank (a
    KV cache: batch rows and heads sharded, positions whole): each rank
    writes its own part, ``vals`` laid out as ``buf`` first.  (torch 2.11's
    DTensor has no rule for ``index_put_``.)"""
    mesh, placements = buf.device_mesh, tuple(buf.placements)
    indexed = {d for d, i in enumerate(idx) if not (isinstance(i, slice) and i == slice(None))}
    if any(isinstance(p, Shard) and p.dim in indexed for p in placements):
        raise ValueError(f"_put into a DTensor sharded on an indexed dim: {placements}")
    vals = vals.to(buf.dtype)
    if not isinstance(vals, DTensor):
        vals = DTensor.from_local(vals, mesh, [Replicate()] * mesh.ndim, run_check=False)
    out = buf.to_local().clone()
    out[tuple(i.full_tensor() if isinstance(i, DTensor) else i for i in idx)] = (
        vals.redistribute(mesh, placements).to_local())
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=buf.shape,
                              stride=buf.stride())


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


# ---------------------------------------------------------------------------
# Paged KV cache (fixed-size pages in a shared pool, per-row page tables —
# the serving-side layout behind repro_torch.serve.paged.PagedLayout).
# Virtual addressing keeps the dense ring semantics bit for bit: virtual
# slot v of row b lives at pool[page_tbl[b, v // page], v % page], so the
# view reproduces exactly the (B, cap, Hkv, hd) tensors the dense cache
# would hold.
#
# Unlike every other state update of the port, appends write the POOLS IN
# PLACE: a pool is shared by every row and sized for a deployment (GBs), so
# an out-of-place append would copy it every step.  ``pos``/``length`` stay
# out of place.  Isolation comes from the page table: a write lands on a
# page the serving layout made private to its row, or on the scratch page.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKVCache:
    """Page-table KV cache node of one layer (always per-slot).

    ``k_pool``/``v_pool`` are shared across rows: (P, page, Hkv, hd) with
    page 0 reserved as a scratch page — unmapped table entries (-1) clamp
    to it, so appends from inactive rows (whose tables the layout has
    cleared) land in scratch instead of on live pages.  ``page_tbl`` is
    (B, n_pages) int32 (-1 = unmapped); the layers of one cache group share
    one table tensor.  ``pos``/``length`` keep the exact dense per-slot
    semantics (pos (B, cap) global positions, -1 empty).
    """

    k_pool: Tensor  # (P, page, Hkv, hd) bf16 or int8
    v_pool: Tensor
    k_scale: Tensor | None  # (P, page, Hkv, 1) f32 when int8
    v_scale: Tensor | None
    page_tbl: Tensor  # (B, n_pages) int32, -1 = unmapped (-> scratch page 0)
    pos: Tensor  # (B, cap) int32 global positions (-1 empty)
    length: Tensor  # (B,) int32 total tokens ever appended per row


#: the pool leaves of a paged node (shared by every row, written in place)
POOL_FIELDS = ("k_pool", "v_pool", "k_scale", "v_scale")


def paged_cache_init(batch: int, cap: int, n_kv: int, hd: int, dtype: str,
                     n_pages: int, page_size: int, device="cpu",
                     page_tbl: Tensor | None = None) -> PagedKVCache:
    """An empty paged node: ``n_pages`` usable pages (+1 scratch) of
    ``page_size`` tokens; ``cap`` is the per-row virtual capacity (the dense
    cache's Smax — ring wrap happens in virtual space).  ``page_tbl``: a
    table tensor to share (the other layers of the group), else a new one."""
    per_row = -(-cap // page_size)
    if n_pages < per_row:
        raise ValueError(
            f"pool of {n_pages} pages cannot hold one full row "
            f"(cap={cap}, page_size={page_size} -> {per_row} pages/row)")
    if page_tbl is None:
        page_tbl = torch.full((batch, per_row), -1, dtype=torch.int32, device=device)
    pos = torch.full((batch, cap), -1, dtype=torch.int32, device=device)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)

    def z(dt, width=hd):
        return torch.zeros((n_pages + 1, page_size, n_kv, width), dtype=dt, device=device)

    if dtype == "int8":
        return PagedKVCache(z(torch.int8), z(torch.int8), z(torch.float32, 1),
                            z(torch.float32, 1), page_tbl, pos, length)
    return PagedKVCache(z(torch.bfloat16), z(torch.bfloat16), None, None,
                        page_tbl, pos, length)


def _paged_addr(cache: PagedKVCache, vi: Tensor) -> tuple[Tensor, Tensor]:
    """Virtual indices (B, S) -> (pool page, in-page offset), clamping
    unmapped entries to the scratch page."""
    ps = cache.k_pool.shape[1]
    pages = torch.take_along_dim(cache.page_tbl, (vi // ps).long(), dim=1)
    return torch.clamp(pages, min=0).long(), (vi % ps).long()


def write_pool_slots(cache: PagedKVCache, pages: Tensor, off: Tensor,
                     values: dict[str, Tensor | None]) -> None:
    """``pool[pages, off] = vals`` in place for each pool leaf named in
    ``values`` (``pages``, ``off``: any equal shape, which leads ``vals``).

    Rows whose table entries are unmapped all write the scratch page, so one
    indexed write may name a slot several times, and which of those values
    lands would be left to the device's scheduling.  Every write to a slot
    carries the value of the LAST write to it instead: the slot then ends
    as a sequential scatter leaves it, on every device and every run.  The
    scratch page's content matters to a MoE model: an inactive row reads
    it, and its hidden state still competes for expert capacity."""
    ps, n_pages = cache.k_pool.shape[1], cache.k_pool.shape[0]
    flat = (pages * ps + off).reshape(-1)
    last = torch.full((n_pages * ps,), -1, dtype=torch.long, device=flat.device)
    last.scatter_reduce_(0, flat, torch.arange(flat.numel(), device=flat.device),
                         reduce="amax")
    src = last[flat]
    for name, vals in values.items():
        pool = getattr(cache, name)
        if pool is not None:
            rows = vals.reshape(-1, *vals.shape[pages.dim():])[src]
            pool[pages, off] = rows.reshape(vals.shape).to(pool.dtype)


def _paged_encode(cache: PagedKVCache, k_new: Tensor, v_new: Tensor) -> dict:
    """What an append stores, per pool leaf: the same cast or int8 row
    quantization as the dense cache."""
    if cache.k_scale is not None:
        kq, ks = _quant_rows(k_new)
        vq, vs = _quant_rows(v_new)
        return {"k_pool": kq, "v_pool": vq, "k_scale": ks, "v_scale": vs}
    return {"k_pool": k_new.to(cache.k_pool.dtype), "v_pool": v_new.to(cache.v_pool.dtype)}


def _paged_slots(cache: PagedKVCache, s_new: int) -> Tensor:
    """Virtual slots (B, s_new) of the next ``s_new`` appends per row."""
    cap = cache.pos.shape[1]
    ar = torch.arange(s_new, dtype=torch.int32, device=cache.pos.device)
    return torch.remainder(cache.length, cap)[:, None] + ar[None, :]


def _paged_advance(cache: PagedKVCache, vi: Tensor) -> PagedKVCache:
    """The node after appending at virtual slots ``vi`` (B, S): new
    ``pos``/``length`` (out of place), the same pools and table."""
    b, s_new = vi.shape
    ar = torch.arange(s_new, dtype=torch.int32, device=vi.device)
    rows = torch.arange(b, device=vi.device)[:, None]
    pos = _put(cache.pos, (rows, vi.long()), cache.length[:, None] + ar[None, :])
    return dataclasses.replace(cache, pos=pos, length=(cache.length + s_new).to(torch.int32))


def paged_append(cache: PagedKVCache, k_new: Tensor, v_new: Tensor) -> PagedKVCache:
    """Per-row ring append through the page table: mirrors
    ``kv_cache_append_slots`` exactly in virtual space (same cast, same int8
    row quantization, same pos/length updates).  Writes the pools IN PLACE
    (only the new rows); multi-token appends must not straddle the virtual
    wrap point, as in the dense contract."""
    vi = _paged_slots(cache, k_new.shape[1])
    pages, off = _paged_addr(cache, vi)
    write_pool_slots(cache, pages, off, _paged_encode(cache, k_new, v_new))
    return _paged_advance(cache, vi)


def paged_view(cache: PagedKVCache) -> tuple[Tensor, Tensor, Tensor | None, Tensor | None]:
    """Materialize the dense (B, cap, Hkv, hd) view attention reads: gather
    pages by table, flatten, trim to the virtual capacity.  Unmapped entries
    read the scratch page — garbage there is masked by ``pos == -1`` in
    flash_attention, so the view equals the dense cache wherever positions
    are valid."""
    cap = cache.pos.shape[1]
    b, npg = cache.page_tbl.shape
    ps = cache.k_pool.shape[1]
    tbl = torch.clamp(cache.page_tbl, min=0).long()

    def view(pool):
        if pool is None:
            return None
        return pool[tbl].reshape(b, npg * ps, *pool.shape[2:])[:, :cap]

    return tuple(view(getattr(cache, name)) for name in POOL_FIELDS)


def paged_append_readonly(cache: PagedKVCache, k_new: Tensor, v_new: Tensor):
    """``paged_append`` followed by ``paged_view``, without writing the
    pools: the new rows are placed into the gathered view instead (the
    adaptation probe's step, which must leave every pool bit-identical).
    Returns (the advanced node, the view)."""
    vi = _paged_slots(cache, k_new.shape[1])
    rows = torch.arange(vi.shape[0], device=vi.device)[:, None]
    view = list(paged_view(cache))
    for i, vals in enumerate(_paged_encode(cache, k_new, v_new).values()):
        view[i][rows, vi.long()] = vals  # the gather's own memory, not a pool
    return _paged_advance(cache, vi), tuple(view)


def paged_scatter_rows(cache: PagedKVCache, k: Tensor, v: Tensor,
                       k_scale: Tensor | None, v_scale: Tensor | None,
                       pos: Tensor, length: Tensor) -> PagedKVCache:
    """Write every row's full (B, cap, ...) virtual content back through the
    page table, in place — the inverse of ``paged_view``.  Rows whose table
    entries are unmapped write the scratch page; rows sharing a page write
    identical bits.  Returns the node with ``pos``/``length`` replaced."""
    cap = cache.pos.shape[1]
    b = cache.page_tbl.shape[0]
    vi = torch.arange(cap, dtype=torch.int32, device=pos.device).expand(b, cap)
    pages, off = _paged_addr(cache, vi)
    write_pool_slots(cache, pages, off, dict(zip(POOL_FIELDS, (k, v, k_scale, v_scale))))
    return dataclasses.replace(cache, pos=pos, length=length)


def paged_save_slots(cache: PagedKVCache, n: int) -> tuple:
    """The pool content at each row's next ``n`` virtual slots, ring wrap
    included (what ``n`` one-token appends will overwrite): (pages,
    offsets, values per pool)."""
    cap = cache.pos.shape[1]
    ar = torch.arange(n, dtype=torch.int32, device=cache.pos.device)
    pages, off = _paged_addr(cache, torch.remainder(cache.length[:, None] + ar, cap))
    vals = [None if getattr(cache, f) is None else getattr(cache, f)[pages, off]
            for f in POOL_FIELDS]
    return pages, off, vals


def paged_restore_slots(cache: PagedKVCache, saved: tuple,
                        where: Tensor | None = None) -> None:
    """Write saved slot content back in place: all of it, or only the
    (B, n) entries where ``where`` holds (the others are rewritten with
    their current content)."""
    pages, off, vals = saved
    values = {}
    for name, old in zip(POOL_FIELDS, vals):
        pool = getattr(cache, name)
        if pool is None:
            continue
        if where is not None:
            m = where.reshape(where.shape + (1,) * (old.dim() - where.dim()))
            old = torch.where(m, old, pool[pages, off])
        values[name] = old
    write_pool_slots(cache, pages, off, values)


def kv_append(cache: KVCache | PagedKVCache, k_new: Tensor, v_new: Tensor):
    """Layout dispatch for cache appends: paged nodes write through their
    page table, dense per-slot nodes ((B,) lengths) ring-append per row,
    shared-length nodes append at one scalar offset."""
    if isinstance(cache, PagedKVCache):
        return paged_append(cache, k_new, v_new)
    if cache.length.dim() == 1:
        return kv_cache_append_slots(cache, k_new, v_new)
    return kv_cache_append(cache, k_new, v_new)


def kv_view(cache: KVCache | PagedKVCache):
    """The (k, v, k_scale, v_scale) tensors attention reads for this node."""
    if isinstance(cache, PagedKVCache):
        return paged_view(cache)
    return cache.k, cache.v, cache.k_scale, cache.v_scale


# ---------------------------------------------------------------------------
# Flash attention (chunked-KV online softmax — never materializes S x S)
# ---------------------------------------------------------------------------

#: the op classes of attention's two contractions
ATTN_SITES = ("attn_qk", "attn_av")


def decode_kernel_misses(q, k, v, policy: PrecisionPolicy, k_scale=None,
                         v_scale=None) -> tuple[str, ...]:
    """Why ``flash_attention`` keeps its chunk loop for this call: the names
    of the decode-attention kernel's unmet conditions, none where the kernel
    takes it.  It takes a call on the card (``device``) of one query a row
    (``sq``) that needs no gradient (``grad``), over a bf16 cache with no
    scales (``cache``), under a kernel policy (``impl``: pallas or tile)
    whose two attention sites are f32-ladder modes (``mode``), static or
    bound at run time (the kernel reads a bound device scalar), at a head
    dim that is a multiple of 16 up to 256 and at most 16 query heads a KV
    head (``shape``).  Only what the call can observe decides.  (The mesh
    path, ``_flash_attention_on_shards``, runs the chunk loop itself.)"""
    misses = []
    if not q.is_cuda:
        misses.append("device")
    if q.shape[1] != 1:
        misses.append("sq")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        misses.append("grad")
    bf16 = k.dtype == torch.bfloat16 and v.dtype == torch.bfloat16
    if not bf16 or k_scale is not None or v_scale is not None:
        misses.append("cache")
    if policy.impl not in ("pallas", "tile"):
        misses.append("impl")
    if any(policy.mode_for(op) not in F32_MODES for op in ATTN_SITES):
        misses.append("mode")
    hq, hd, hkv = q.shape[2], q.shape[3], k.shape[2]
    if hd % 16 or hd > MAX_HEAD_DIM or hq % hkv or hq // hkv > MAX_GROUP:
        misses.append("shape")
    return tuple(misses)


def _site_mode(op: str, policy: PrecisionPolicy):
    """The mode ``pein`` runs ``op`` at: a bound device scalar as it is, a
    bound host int clamped to the f32 ladder (``mp_einsum_runtime``'s
    host branch), else the policy's static mode."""
    rt = runtime_mode_for(op)
    if rt is None:
        return policy.mode_for(op)
    if isinstance(rt, Tensor):
        return rt
    return F32_MODES[min(max(int(rt) - 1, 0), len(F32_MODES) - 1)]


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
    """Online-softmax attention, KV walked in chunks (a Python loop:
    ``kernels.decode_attention.chunked_attention``).

    GQA: Hq = Hkv * G.  Scores and attention-value products go through the
    RMPM engine ('attn_qk' / 'attn_av' op classes) — which is why no fused
    attention operator can stand in for this function.  Where
    ``decode_kernel_misses`` names nothing (a decode step on the card over a
    bf16 cache at f32-ladder modes), the two contractions run in the
    hand-written decode-attention kernel instead, at the modes ``pein``
    would run (a bound site's too), in one device span ``attn_decode``; a
    K or V laid out otherwise than the kernel reads is copied first.
    """
    if decode_kernel_misses(q, k, v, policy, k_scale, v_scale):
        return _flash_attention_chunks(
            q, k, v, policy, causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
            kv_positions=kv_positions, k_scale=k_scale, v_scale=v_scale, chunk=chunk)
    b, skv, dev = q.shape[0], k.shape[1], q.device
    if kv_positions is None:
        kv_positions = torch.arange(skv, dtype=torch.int32, device=dev)
        if kv_len is not None:
            kv_positions = torch.where(kv_positions < kv_len, kv_positions,
                                       torch.full_like(kv_positions, -1))
    if not isinstance(q_offset, Tensor):
        q_offset = torch.full((b,), q_offset, dtype=torch.int32, device=dev)
    with device_span("attn_decode"):
        k, v = (x if kernel_takes_kv(x) else x.clone(memory_format=torch.contiguous_format)
                for x in (k, v))
        return decode_attention(
            q, k, v, q_offset.expand(b), kv_positions, qk_mode=_site_mode("attn_qk", policy),
            av_mode=_site_mode("attn_av", policy), rounding=policy.rounding, causal=causal,
            window=window)


def _flash_attention_chunks(q, k, v, policy: PrecisionPolicy, **kw) -> Tensor:
    """``chunked_attention`` with the policy-routed einsums (device spans
    ``attn_qk`` and ``attn_av``)."""
    return chunked_attention(
        q, k, v, lambda qg, kt: pein(QK_EQ, qg, kt, "attn_qk", policy),
        lambda p, vt: pein(AV_EQ, p, vt, "attn_av", policy), **kw)


def _batch_laid_out(x, mesh, qp, batched_ndim: int):
    """A position or offset tensor as this rank's local tensor for q laid out
    by ``qp``: with ``batched_ndim`` dims its first is the batch, split where
    q's rows are (the per-slot layout); otherwise it is whole."""
    if not isinstance(x, DTensor):
        return x
    if x.ndim != batched_ndim:
        return x.full_tensor()
    return x.redistribute(mesh, [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                                 for p in qp]).to_local()


def _flash_attention_on_shards(q, k, v, policy, *, causal: bool, window: int,
                               chunk: int, q_offset=0, kv_positions=None, k_scale=None,
                               v_scale=None):
    """``flash_attention`` of DTensor q/k/v (B, S, H, hd), each rank on its
    own shard, as GSPMD partitions the reference's: batch rows and heads are
    independent, and a rank's rows of a sequence-sharded q attend to the
    whole K/V from their own offset.  Per mesh dimension, a batch or head
    shard of q is kept and given to K/V (heads only where the KV head count
    divides it), a sequence shard of q is kept with K/V whole there, and
    anything else is replicated first.  (DTensor's own rules for the
    einsums would flatten (batch, heads), which torch 2.11 refuses when
    either is sharded.)  Each rank runs the chunk loop: the mesh path
    does not take the decode-attention kernel."""
    mesh = q.device_mesh
    sizes = mesh.shape
    qp, kvp, seq_dims = [], [], []
    for i, p in enumerate(q.placements):
        d = p.dim if isinstance(p, Shard) else None
        if d == 0 or (d == 2 and k.shape[2] % sizes[i] == 0):
            qp.append(p)
            kvp.append(p)
        elif d == 1:
            qp.append(p)
            kvp.append(Replicate())
            seq_dims.append(i)
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
    ql = q.redistribute(mesh, qp).to_local()
    # where q's rows are split and K/V whole, each rank's K/V gradient is its
    # rows' share of the sum
    kv_grad = [Partial() if i in seq_dims else p for i, p in enumerate(kvp)]
    kl, vl = (x.redistribute(mesh, kvp).to_local(grad_placements=kv_grad) for x in (k, v))
    scales = [None if x is None else x.redistribute(mesh, kvp).to_local()
              for x in (k_scale, v_scale)]
    coord, first = mesh.get_coordinate(), 0
    for i in seq_dims:  # mesh order: the first dimension is the outer one
        first = first * sizes[i] + coord[i]
    out = _flash_attention_chunks(
        ql, kl, vl, policy, causal=causal, window=window, chunk=chunk,
        q_offset=_batch_laid_out(q_offset, mesh, qp, 1) + first * ql.shape[1],
        kv_positions=_batch_laid_out(kv_positions, mesh, kvp, 2),
        k_scale=scales[0], v_scale=scales[1])
    return DTensor.from_local(out, mesh, qp, run_check=False)


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
    cache: KVCache | PagedKVCache | None = None,
    window: int = 0,
    causal: bool = True,
    write_pools: bool = True,
    kv_override: tuple[Tensor, Tensor] | None = None,
) -> tuple[Tensor, KVCache | PagedKVCache | None]:
    """``write_pools=False``: a paged decode step reads its fresh K/V from
    the gathered view and leaves the pools untouched (dense caches are
    never written in place).

    ``kv_override=(enc_out, enc_out)``: cross-attention, as the reference's.
    K and V are projected from the encoder output on every call; there is
    no RoPE, no cache read or write and no causal mask."""
    policy = cfg.policy
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = split_dim(plinear(x, p["wq"], "qkv", policy), -1, hq, hd)
    if kv_override is None:
        k = split_dim(plinear(x, p["wk"], "qkv", policy), -1, hkv, hd)
        v = split_dim(plinear(x, p["wv"], "qkv", policy), -1, hkv, hd)
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cfg.attn_shard == "sequence":
            # sequence-parallel attention: Q stays S-sharded over 'model';
            # K/V are gathered (small for GQA)
            q = constrain(q, BATCH_AXES, "model", None, None)
            k = constrain(k, BATCH_AXES, None, None, None)
            v = constrain(v, BATCH_AXES, None, None, None)
        else:
            q = constrain(q, BATCH_AXES, None, "model", None)
            k = constrain(k, BATCH_AXES, None, "model", None)
            v = constrain(v, BATCH_AXES, None, "model", None)
    else:
        enc = kv_override[0]
        k = split_dim(plinear(enc, p["wk"], "qkv", policy), -1, hkv, hd)
        v = split_dim(plinear(enc, p["wv"], "qkv", policy), -1, hkv, hd)
        causal = False

    attend = _flash_attention_on_shards if isinstance(q, DTensor) else flash_attention
    if cache is not None and kv_override is None:
        q_offset = cache.length
        if isinstance(cache, PagedKVCache) and not write_pools:
            cache, view = paged_append_readonly(cache, k, v)
        else:
            cache = kv_append(cache, k, v)
            view = None
        if s > 1:
            # prefill: attend over the fresh full-length K/V (the window
            # cache may be smaller than the prompt; it keeps only the tail)
            fresh_pos = torch.arange(s, dtype=torch.int32, device=x.device)
            fresh_pos = (q_offset[:, None] if q_offset.dim() else q_offset) + fresh_pos
            out = attend(
                q, k, v, policy, causal=causal, window=window,
                q_offset=q_offset, kv_positions=fresh_pos, chunk=cfg.attn_chunk,
            )
        else:
            k_read, v_read, ks_read, vs_read = view or kv_view(cache)
            out = attend(
                q, k_read, v_read, policy, causal=causal, window=window,
                q_offset=q_offset, kv_positions=cache.pos,
                k_scale=ks_read, v_scale=vs_read, chunk=cfg.attn_chunk,
            )
    else:
        out = attend(q, k, v, policy, causal=causal, window=window, chunk=cfg.attn_chunk)
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


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                  layers: int | None = None) -> Params:
    """The enc-dec family's MLP: up and down projections with biases."""
    return {
        "up": dense_init(gen, d_model, d_ff, bias=True, layers=layers),
        "down": dense_init(gen, d_ff, d_model, bias=True, layers=layers),
    }


def gelu_mlp_apply(p: Params, x: Tensor, policy: PrecisionPolicy) -> Tensor:
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(plinear(x, p["up"], "mlp_up", policy), approximate="tanh")
    return plinear(h, p["down"], "mlp_down", policy)


# ---------------------------------------------------------------------------
# Causal depthwise conv (SSM / RG-LRU front)
# ---------------------------------------------------------------------------


def _pad_sequence(x: Tensor, n: int) -> Tensor:
    """(B, S, C) -> (B, n + S, C), zeros first.  A DTensor whose sequence is
    whole on every rank is padded shard by shard (torch 2.11's DTensor fails
    to lay out ``F.pad``'s input)."""
    if isinstance(x, DTensor) and not any(isinstance(p, Shard) and p.dim == 1
                                          for p in x.placements):
        shape = (x.shape[0], x.shape[1] + n, x.shape[2])
        return DTensor.from_local(F.pad(x.to_local(), (0, 0, n, 0)), x.device_mesh,
                                  x.placements, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))
    return F.pad(x, (0, 0, n, 0))


def causal_conv1d(x: Tensor, w: Tensor, state: Tensor | None = None):
    """x: (B, S, C); w: (K, C) depthwise.  Returns (y, new_state) where
    state carries the trailing K-1 inputs for decode.  The K taps are summed
    in the reference's order, so the result is the reference's bit for bit."""
    ksz = w.shape[0]
    if state is None:
        xp = _pad_sequence(x, ksz - 1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(ksz))
    new_state = xp[:, -(ksz - 1):, :] if ksz > 1 else None
    return y, new_state
