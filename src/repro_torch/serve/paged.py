"""KV-cache layouts behind one protocol: dense slot rows or paged pools.

The engine talks to its decode state through a :class:`KVLayout`

    init / gather_row / scatter_row / free_row /
    can_admit / prepare_step / tier_tick / describe

so that prefill, park/resume and the masked step never see the layout.  Two
implementations:

* :class:`DenseLayout` — the per-slot ring cache: every row owns
  ``max_len`` rows of every cache up front, so all hooks but gather/scatter
  are trivial (the default);
* :class:`PagedLayout` — every attention cache group becomes a list of
  :class:`~repro_torch.models.layers.PagedKVCache` nodes (one per layer)
  over fixed-size pages in a shared pool, with per-row page tables,
  allocation on append and free on completion or eviction.  Each group has
  its own capacity (the hybrid's local-attention group holds its window,
  a ring).  Recurrent states (``SSMState``, ``RGLRUState``) have nothing to
  page: they stay per-slot dense nodes inside the paged state, with a
  batch axis, gathered and scattered bit for bit.  Virtual
  addressing keeps the dense ring semantics exactly, so at full precision
  paged serving gives the dense layout's tokens — while admission is gated
  on free *pages*, so short-lived requests stack past the dense
  ``slots x max_len`` wall.

On top of the paged layout ride the two things a fixed layout cannot offer
(DESIGN.md section Paged KV cache):

* **precision-tiered pages** — cold pages are mantissa-truncated in place by
  the ``quantize_mantissa`` kernel (``csrc/quantize_mantissa.cu``) under a
  :class:`~repro_torch.adapt.pages.PageTierController` (demotion is lossy;
  promotion restores the floor);
* **radix-style prefix sharing** — page ``j`` of a prompt's KV depends only
  on ``prompt[:(j+1)*page_size]`` (causal attention), so that byte string
  keys a per-group index of read-only shared pages.  A row never writes a
  shared or index-held page: decode appends and ring wraps trigger
  copy-on-write forks in :meth:`PagePool.cow`.

The exchange format between layouts is the *dense solo row*: ``gather_row``
returns the same per-slot batch-1 ``DecodeState`` the solo prefill produces,
so parking, resume and prefill stay layout-agnostic.

Pools are written in place (a decode step appends into them, see
``models.layers``), and so is everything the paged layout does between
steps: page-table pushes (``copy_`` of the host tables into the device
``page_tbl`` tensor, never a rebinding), row scatters, copy-on-write page
copies and tier passes.  The state's tensors therefore keep their addresses,
which the engine's captured steps hold.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.adapt.pages import HOT, PageTierController
from repro_torch.kernels.quantize_mantissa.ops import quantize_mantissa_op
from repro_torch.models.layers import (
    POOL_FIELDS,
    KVCache,
    PagedKVCache,
    paged_cache_init,
    paged_restore_slots,
    paged_save_slots,
)
from repro_torch.models.lm import DecodeState, map_state, state_leaves
from repro_torch.obs import NULL_TRACER
from repro_torch.serve.config import CacheConfig

#: axes sentinel for leaves shared by every row (no batch axis): the paged
#: pools and page tables.  The masked step's row_select keeps the *new*
#: value (the same tensor: pools are written in place, tables not at all) —
#: per-row isolation is the page table's job (cleared tables redirect
#: inactive rows' writes to the scratch page).
SHARED = -1
BATCH_AXIS = 0


def _batch_node(node):
    """A recurrent-state node with every field at the batch axis."""
    return type(node)(*[None if getattr(node, f.name) is None else BATCH_AXIS
                        for f in dataclasses.fields(node)])


def _gather_node(node, slot: int):
    """Row ``slot`` of a per-slot dense node, a copy (it outlives the step)."""
    return type(node)(*[None if (x := getattr(node, f.name)) is None
                        else x[slot:slot + 1].clone() for f in dataclasses.fields(node)])


def _scatter_node(node, row, slot: int) -> None:
    """Write a batch-1 row into ``slot`` of a per-slot dense node, in place."""
    for f in dataclasses.fields(node):
        x = getattr(node, f.name)
        if x is not None:
            x[slot:slot + 1] = getattr(row, f.name).to(x.dtype)


def _recurrent_note(axes: DecodeState) -> str:
    """The describe() suffix for a layout's recurrent-state nodes (the
    nodes of ``axes`` that are not attention caches), or ''."""
    n = sum(len(nodes) for nodes in axes.caches.values()
            if not isinstance(nodes[0], (KVCache, PagedKVCache)))
    return f" | recurrent state: {n} per-slot dense nodes" if n else ""


def compute_axes(state: DecodeState) -> DecodeState:
    """Per-leaf batch-axis tree of a per-slot dense decode state.  The
    reference finds the axis by diffing abstract shapes at two slot counts,
    because its caches carry a stacked layer axis in front; the port keeps
    one cache per layer, so the batch axis of every dense leaf is 0."""
    return map_state(lambda x: BATCH_AXIS, state)


def batch_leaves(axes: DecodeState, state: DecodeState) -> list[torch.Tensor]:
    """The leaves of ``state`` that have a batch axis: what a step merges
    per row and copies back (the shared pools and tables are left out)."""
    return [x for ax, x in zip(state_leaves(axes), state_leaves(state), strict=True)
            if ax >= 0]


def save_pools(state: DecodeState, n: int) -> dict:
    """Per paged node of ``state`` (by ``id``), the pool content at each
    row's next ``n`` slots: what ``n`` one-token appends overwrite in place
    (a speculative round; a captured step's warm-up, which runs the step
    once for real).  Empty for a dense state."""
    return {id(node): paged_save_slots(node, n)
            for layers in state.caches.values() for node in layers
            if isinstance(node, PagedKVCache)}


def restore_pools(state: DecodeState, saved: dict) -> None:
    """Write back, in place, everything :func:`save_pools` saved."""
    for layers in state.caches.values():
        for node in layers:
            if id(node) in saved:
                paged_restore_slots(node, saved[id(node)])


# ---------------------------------------------------------------------------
# Device primitives on one PagedKVCache node (one layer)
# ---------------------------------------------------------------------------


def paged_gather_row(c: PagedKVCache, slot: int) -> KVCache:
    """Materialize row ``slot`` as a dense batch-1 per-slot ``KVCache`` —
    the layout-agnostic exchange format (park/resume speak dense rows).
    Unmapped page-table entries read the scratch page; the garbage there is
    outside the row's valid positions, and scatter_row writes the same
    region back, so park -> resume round-trips bit-exactly."""
    cap = c.pos.shape[1]
    npg, ps = c.page_tbl.shape[1], c.k_pool.shape[1]
    tbl = torch.clamp(c.page_tbl[slot:slot + 1], min=0).long()

    def g(pool):
        if pool is None:
            return None
        return pool[tbl].reshape(1, npg * ps, *pool.shape[2:])[:, :cap]

    return KVCache(*(g(getattr(c, f)) for f in POOL_FIELDS),
                   c.pos[slot:slot + 1].clone(), c.length[slot:slot + 1].clone())


def paged_scatter_row(c: PagedKVCache, row: KVCache, slot: int,
                      write_tbl: torch.Tensor) -> None:
    """Write a dense batch-1 row into the pools through ``write_tbl`` — the
    per-page *write* table: entries of -1 (shared prefix pages, unmapped
    tail) redirect to the scratch page, so read-only pages are never
    touched.  ``pos``/``length`` are per-row leaves and always written.  In
    place."""
    cap = c.pos.shape[1]
    ps = c.k_pool.shape[1]
    vi = torch.arange(cap, device=write_tbl.device)
    pages = torch.clamp(write_tbl[vi // ps], min=0).long()
    off = vi % ps
    for name, vals in zip(POOL_FIELDS, (row.k, row.v, row.k_scale, row.v_scale)):
        pool = getattr(c, name)
        if pool is not None:
            pool[pages, off] = vals[0].to(pool.dtype)
    c.pos[slot:slot + 1] = row.pos
    c.length[slot:slot + 1] = row.length


def copy_page_node(node: PagedKVCache, src: int, dst: int) -> None:
    """Device-side copy-on-write fork: duplicate pool page ``src`` into the
    freshly allocated ``dst`` (every pool leaf of the node).  In place."""
    for name in POOL_FIELDS:
        pool = getattr(node, name)
        if pool is not None:
            pool[dst].copy_(pool[src])


def tier_node(nodes: list[PagedKVCache], demote: torch.Tensor, shadow: torch.Tensor,
              keep: int | None, next_keep: int | None, rounding: str,
              quantize=quantize_mantissa_op):
    """Demote the pages in ``demote`` (bool (P,)) of every node of a group
    to ``keep`` mantissa bits, in place, through the quantize_mantissa
    kernel, and measure

      * ``err``      — max relative residual the applied demotions introduced;
      * ``err_down`` — would-be residual of truncating the ``shadow`` pages
        to ``next_keep`` (computed, never applied — controller invariant ii:
        the config being *entered* is measured before entering it).

    ``keep=None`` applies nothing (depth 0: the shadow still measures).
    ``quantize``: the rounding function (the kernel's wrapper; a check may
    pass its plain version).  Returns (err, err_down) as device scalars.  The reference passes over a
    layer-stacked group at once; here the group is walked one node (one
    layer) at a time, so the f32 copies live for one node only.  The
    residuals are max |f - q| over max |f| across the whole group, as the
    reference reduces them."""
    dev = demote.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # per pool kind: [max |f - q|, max |f|] over the demoted, then the shadow
    acc = {name: [zero, zero, zero, zero] for name in ("k_pool", "v_pool")}
    m_demote = demote.reshape(-1, 1, 1, 1)
    m_shadow = shadow.reshape(-1, 1, 1, 1)

    def residual(f, bits, m, a, i):
        q = quantize(f, bits, rounding=rounding)
        a[i] = torch.maximum(a[i], torch.where(m, (f - q).abs(), 0.0).amax())
        a[i + 1] = torch.maximum(a[i + 1], torch.where(m, f.abs(), 0.0).amax())
        return q

    for node in nodes:
        for name, a in acc.items():
            pool = getattr(node, name)
            f = pool.to(torch.float32)
            if next_keep is not None:  # before the demotion lands: the same f
                residual(f, next_keep, m_shadow, a, 2)
            if keep is not None:
                q = residual(f, keep, m_demote, a, 0)
                pool.copy_(torch.where(m_demote, q, f))

    def ratio(a, i):
        return a[i] / (a[i + 1] + 1e-30)

    err = torch.maximum(ratio(acc["k_pool"], 0), ratio(acc["v_pool"], 0))
    if next_keep is None:
        return err, err
    return err, torch.maximum(ratio(acc["k_pool"], 2), ratio(acc["v_pool"], 2))


# ---------------------------------------------------------------------------
# Host-side page-pool allocator (one per cache group)
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list allocator + refcounts + prefix index for one cache group.

    Pool indices are 1-based: page 0 is the scratch page (-1 table entries
    clamp to it on device).  ``ref`` counts *row* references; pages whose
    refcount drops to zero while registered in the prefix index park in an
    LRU of ``cached`` pages — still shareable, reclaimed (index entry
    dropped) only when the free list runs dry.  A page is privately
    writable iff ``ref == 1`` and it is not index-held; everything else
    forks via :meth:`cow`.
    """

    def __init__(self, n_pages: int, page_size: int, cap: int, rows: int):
        self.ps = page_size
        self.cap = cap
        self.rows = rows
        self.per_row = -(-cap // page_size)
        if n_pages < self.per_row:
            raise ValueError(
                f"pool of {n_pages} pages cannot hold one full row "
                f"(cap={cap}, page_size={page_size})")
        self.n_pages = n_pages
        self.free: collections.deque[int] = collections.deque(
            range(1, n_pages + 1))
        self.ref = np.zeros(n_pages + 1, np.int32)
        self.tier = np.full(n_pages + 1, HOT, np.int32)  # keep-bits labels
        self.tbl = np.full((rows, self.per_row), -1, np.int32)
        self.index: dict[bytes, int] = {}  # prefix key -> shared page
        self.page_key: dict[int, bytes] = {}
        self.cached: dict[int, None] = {}  # ref==0 index-held pages (LRU)
        self.reserved = 0  # admission-gate reservations (reset each admit)
        self.shared_hits = 0
        self.cow_copies = 0
        self.index_evictions = 0

    # -- capacity ------------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` of virtual content (ring-clamped)."""
        return -(-min(max(n_tokens, 1), self.cap) // self.ps)

    def available(self) -> int:
        return len(self.free) + len(self.cached) - self.reserved

    def _alloc(self) -> int | None:
        if self.free:
            p = self.free.popleft()
        elif self.cached:
            # reclaim the LRU prefix-cache page: drop its index entry
            p = next(iter(self.cached))
            del self.cached[p]
            key = self.page_key.pop(p)
            del self.index[key]
            self.index_evictions += 1
        else:
            return None
        self.ref[p] = 1
        self.tier[p] = HOT
        return p

    def _release(self, p: int) -> None:
        self.ref[p] -= 1
        if self.ref[p] == 0:
            if p in self.page_key:
                self.cached[p] = None  # shareable until reclaimed
            else:
                self.free.append(p)

    # -- row lifecycle -------------------------------------------------------

    def free_row(self, row: int) -> None:
        """Drop every page reference of ``row`` and clear its table — the
        engine calls this on completion and on eviction BEFORE the next
        step, so freed pages can never be written through a stale table."""
        for p in self.tbl[row]:
            if p >= 0:
                self._release(int(p))
        self.tbl[row] = -1

    def peek_needed(self, n_tokens: int, keys: list[bytes] | None) -> int:
        """Fresh pages a new row of ``n_tokens`` content (+1 append slot)
        would allocate after prefix-sharing hits — the admission gate."""
        target = self.pages_for(n_tokens + 1)
        hits = 0
        if keys is not None and n_tokens <= self.cap:
            for j in range(min(n_tokens // self.ps, target)):
                if keys[j] in self.index:
                    hits += 1
        return target - hits

    def attach(self, row: int, n_tokens: int,
               keys: list[bytes] | None) -> np.ndarray | None:
        """Map a new row covering ``n_tokens`` content (+1 append slot).
        Full prompt pages with an index hit attach read-only (refcount++);
        misses allocate and — when keyed — register in the prefix index.
        Returns the per-page *write* table (-1 = shared page, skip the
        write) or None when the pool is exhausted."""
        target = self.pages_for(n_tokens + 1)
        wt = np.full(self.per_row, -1, np.int32)
        shareable = keys is not None and n_tokens <= self.cap
        for j in range(target):
            key = (keys[j] if shareable and j < n_tokens // self.ps else None)
            if key is not None:
                p = self.index.get(key)
                if p is not None:
                    if self.ref[p] == 0:
                        self.cached.pop(p, None)
                    self.ref[p] += 1
                    self.tbl[row, j] = p
                    self.shared_hits += 1
                    continue
            p = self._alloc()
            if p is None:
                return None
            self.tbl[row, j] = p
            wt[j] = p
            if key is not None:
                self.index[key] = p
                self.page_key[p] = key
        return wt

    def ensure(self, row: int, upto_tokens: int) -> bool:
        """Extend ``row``'s mapping to cover ``upto_tokens`` of virtual
        content (the pre-step allocation-on-append)."""
        for j in range(self.pages_for(upto_tokens)):
            if self.tbl[row, j] < 0:
                p = self._alloc()
                if p is None:
                    return False
                self.tbl[row, j] = p
        return True

    def cow(self, row: int, lo: int, hi: int) -> tuple[list[tuple[int, int]], bool]:
        """Make the pages overlapping virtual token range [lo, hi) privately
        writable: shared (ref > 1) or index-held pages fork into fresh
        allocations.  Returns the (src, dst) device-copy pairs and whether
        every page could fork.  On exhaustion the forks already made stay
        in the table, so their pairs are returned too: the caller must copy
        them, or the row would later read a page that never received its
        content (the reference returns None here and drops them)."""
        pairs: list[tuple[int, int]] = []
        for j in sorted({(v % self.cap) // self.ps for v in range(lo, hi)}):
            p = int(self.tbl[row, j])
            if p < 0:
                continue  # unmapped: ensure() allocates fresh, nothing to fork
            if self.ref[p] == 1 and p not in self.page_key:
                continue  # exclusively owned: writable in place
            d = self._alloc()
            if d is None:
                return pairs, False
            self.tier[d] = self.tier[p]  # the fork inherits the tier label
            self._release(p)
            self.tbl[row, j] = d
            pairs.append((p, d))
            self.cow_copies += 1
        return pairs, True

    # -- tiering / stats -----------------------------------------------------

    def page_ages(self, lengths: dict[int, int]) -> dict[int, int]:
        """Per referenced page, the minimum over referencing rows of how far
        its newest token trails that row's head.  Ring-wrapped rows
        (length > cap) keep all their pages hot — a wrapped page mixes old
        and new tokens, so age is ill-defined for it.  Index-cached pages
        with no row reference are never demoted (future sharers expect the
        precision they were written at)."""
        ages: dict[int, int] = {}
        for row, ln in lengths.items():
            if ln > self.cap:
                continue
            for j in range(self.pages_for(ln)):
                p = int(self.tbl[row, j])
                if p < 0:
                    continue
                age = ln - min((j + 1) * self.ps, ln)
                ages[p] = min(ages.get(p, 1 << 30), age)
        return ages

    def stats(self) -> dict:
        used = int((self.ref > 0).sum())
        mapped_refs = int((self.tbl >= 0).sum())
        unique = len({int(p) for p in self.tbl.ravel() if p >= 0})
        mix: dict[str, int] = {}
        for p in range(1, self.n_pages + 1):
            if self.ref[p] > 0 or p in self.cached:
                t = int(self.tier[p])
                mix[str(t) if t != HOT else "hot"] = (
                    mix.get(str(t) if t != HOT else "hot", 0) + 1)
        return {
            "pages_total": self.n_pages,
            "pages_used": used,
            "pages_cached": len(self.cached),
            "mapped_refs": mapped_refs,
            "unique_pages": unique,
            "tier_mix": mix,
            "shared_hits": self.shared_hits,
            "cow_copies": self.cow_copies,
            "index_evictions": self.index_evictions,
        }


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


class KVLayout:
    """Protocol shared by :class:`DenseLayout` and :class:`PagedLayout` (see
    the module docstring)."""

    name = "abstract"
    axes = None
    #: trace sink (repro_torch.obs) — the engine swaps in its live tracer
    tracer = NULL_TRACER

    def init(self):
        raise NotImplementedError

    def gather_row(self, state, slot: int):
        raise NotImplementedError

    def scatter_row(self, state, row, slot: int, *, prompt=None, length=None):
        raise NotImplementedError

    def free_row(self, state, slot: int):
        return state

    def begin_admission(self) -> None:
        pass

    def can_admit(self, n_tokens: int, prompt=None) -> bool:
        return True

    def prepare_step(self, state, lengths: dict[int, int], ahead: int):
        return state, []

    def tier_tick(self, state, lengths: dict[int, int], step: int):
        return state, None

    def page_stats(self) -> dict | None:
        return None

    def describe(self) -> str:
        raise NotImplementedError


class DenseLayout(KVLayout):
    """The per-slot ring cache.  Slots are the only resource."""

    name = "dense"

    def __init__(self, model, slots: int, max_len: int):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.axes = compute_axes(model.init_decode_state(1, 1, per_slot=True))

    def init(self) -> DecodeState:
        return self.model.init_decode_state(self.slots, self.max_len, per_slot=True)

    def gather_row(self, state: DecodeState, slot: int) -> DecodeState:
        """Row ``slot`` as a batch-1 state (a copy: it outlives the step)."""
        return map_state(lambda s: s[slot:slot + 1].clone(), state)

    def scatter_row(self, state: DecodeState, row: DecodeState, slot: int, *,
                    prompt=None, length=None) -> DecodeState:
        """Write a batch-1 row into ``slot``.  Out of place, like every dense
        state update of the port: the other rows are copied bit for bit."""
        def put(s, r):
            out = s.clone()
            out[slot:slot + 1] = r.to(s.dtype)
            return out

        return map_state(put, state, row)

    def describe(self) -> str:
        return (f"dense ring cache: {self.slots} slots x {self.max_len} "
                f"rows (admission on free slots){_recurrent_note(self.axes)}")


@dataclasses.dataclass
class _Group:
    """One KV cache group of the decode state: the per-layer nodes under one
    key of ``DecodeState.caches``, which share one page pool and table."""

    key: str
    cap: int
    n_kv: int
    hd: int
    dtype: str
    layers: int
    pool: PagePool


class PagedLayout(KVLayout):
    """Page-table layout: every KV group shares a page pool; per-row page
    tables live on the host (numpy) and are pushed into the device
    ``page_tbl`` tensors lazily (before any step, gather or scatter reads
    them)."""

    name = "paged"

    def __init__(self, model, slots: int, max_len: int, cfg: CacheConfig):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.cfg = cfg
        ps = cfg.page_size
        # one row of the dense state: each attention group's capacity, heads
        # and dtype; the recurrent groups stay dense per-slot nodes
        spec = model.init_decode_state(1, max_len, per_slot=True)
        kv_keys = [key for key in spec.caches if isinstance(spec.caches[key][0], KVCache)]
        self.state_keys = [key for key in spec.caches if key not in kv_keys]
        #: the model's order of the cache groups, kept by every state and
        #: axes tree this layout builds (leaves are zipped in that order)
        self.keys = list(spec.caches)
        caps = [spec.caches[key][0].pos.shape[-1] for key in kv_keys]
        ppr_max = max((-(-c // ps) for c in caps), default=1)
        if cfg.pool_pages is None:
            # memory-equivalent to the dense layout at this slot count
            self.dense_equiv_slots = slots
        else:
            self.dense_equiv_slots = cfg.pool_pages // ppr_max
            if self.dense_equiv_slots < 1:
                raise ValueError(
                    f"pool_pages={cfg.pool_pages} below one row of the "
                    f"largest group ({ppr_max} pages of {ps} tokens)")
        self.groups: list[_Group] = []
        for key in kv_keys:
            layers = spec.caches[key]
            n = layers[0]
            cap = n.pos.shape[-1]
            dtype = "int8" if n.k.dtype == torch.int8 else "bf16"
            if cfg.tier_policy is not None and dtype != "bf16":
                raise ValueError(
                    "tier_policy requires a bfloat16 KV cache "
                    "(mantissa truncation of int8 pages is meaningless)")
            per_row = -(-cap // ps)
            n_pages = max(self.dense_equiv_slots * per_row, per_row)
            self.groups.append(_Group(
                key=key, cap=cap, n_kv=n.k.shape[-2], hd=n.k.shape[-1],
                dtype=dtype, layers=len(layers),
                pool=PagePool(n_pages, ps, cap, slots)))
        state_axes = {key: [_batch_node(n) for n in spec.caches[key]]
                      for key in self.state_keys}
        del spec
        self.tier_ctrl = (PageTierController(cfg.tier_policy)
                          if cfg.tier_policy is not None else None)
        self._dirty = True

        def node_axes(g):
            scale = SHARED if g.dtype == "int8" else None
            return PagedKVCache(SHARED, SHARED, scale, scale, SHARED, BATCH_AXIS, BATCH_AXIS)

        group_axes = {g.key: [node_axes(g)] * g.layers for g in self.groups}
        self.axes = DecodeState(
            caches={key: state_axes[key] if key in state_axes else group_axes[key]
                    for key in self.keys},
            position=BATCH_AXIS, enc_out=None)

    # -- state construction --------------------------------------------------

    def init(self) -> DecodeState:
        """The paged decode state: per attention group, one node per layer
        over its own pools, all sharing the group's one table tensor; per
        recurrent group, the dense per-slot nodes (a state made at
        ``max_len`` 1: the recurrent states do not depend on it)."""
        dev = self.model.device
        dense = self.model.init_decode_state(self.slots, 1, per_slot=True)
        caches = {key: dense.caches[key] for key in self.state_keys}
        del dense
        for g in self.groups:
            tbl = torch.full((self.slots, g.pool.per_row), -1, dtype=torch.int32, device=dev)
            caches[g.key] = [
                paged_cache_init(self.slots, g.cap, g.n_kv, g.hd,
                                 "int8" if g.dtype == "int8" else "bfloat16",
                                 g.pool.n_pages, g.pool.ps, device=dev, page_tbl=tbl)
                for _ in range(g.layers)]
        position = torch.zeros((self.slots,), dtype=torch.int32, device=dev)
        return DecodeState(caches={key: caches[key] for key in self.keys},
                           position=position, enc_out=None)

    def _sync(self, state: DecodeState) -> None:
        """Push the host page tables into the device ``page_tbl`` tensors
        (``copy_``: the tensors a captured step reads stay the same).
        Called before anything reads or writes through the tables, so a
        freed row's pages can never be touched via a stale device table."""
        if not self._dirty:
            return
        for g in self.groups:
            host = torch.from_numpy(g.pool.tbl)
            pushed = set()
            for node in state.caches[g.key]:
                if id(node.page_tbl) not in pushed:
                    node.page_tbl.copy_(host, non_blocking=True)
                    pushed.add(id(node.page_tbl))
        self._dirty = False

    # -- KVLayout hooks ------------------------------------------------------

    def _keys(self, prompt) -> list[bytes] | None:
        if not self.cfg.prefix_sharing or prompt is None:
            return None
        p = np.asarray(prompt, np.int32)
        ps = self.cfg.page_size
        return [p[:(j + 1) * ps].tobytes() for j in range(len(p) // ps)]

    def gather_row(self, state: DecodeState, slot: int) -> DecodeState:
        self._sync(state)
        paged = {g.key for g in self.groups}
        caches = {key: [paged_gather_row(n, slot) if key in paged else _gather_node(n, slot)
                        for n in nodes]
                  for key, nodes in state.caches.items()}
        return DecodeState(caches=caches, position=state.position[slot:slot + 1].clone(),
                           enc_out=None)

    def scatter_row(self, state: DecodeState, row: DecodeState, slot: int, *,
                    prompt=None, length=None) -> DecodeState:
        """Map the row's pages (prefix hits attach read-only) and write the
        dense row through the write table, in place.  Returns ``state``."""
        n = len(prompt) if prompt is not None else int(length)
        keys = self._keys(prompt)
        write_tbls = []
        hits0 = (sum(g.pool.shared_hits for g in self.groups)
                 if self.tracer.enabled else 0)
        for g in self.groups:
            g.pool.free_row(slot)  # drop any stale mapping (defensive no-op)
            wt = g.pool.attach(slot, n, keys)
            if wt is None:
                raise RuntimeError(
                    "page pool exhausted inside scatter_row — the admission "
                    "gate should have reserved these pages")
            write_tbls.append(torch.from_numpy(wt).to(state.position.device))
        if self.tracer.enabled:
            hits = sum(g.pool.shared_hits for g in self.groups) - hits0
            if hits:
                self.tracer.emit("prefix_share", slot=slot,
                                 cause="prompt_prefix", pages=hits)
                self.tracer.inc("prefix_shared_pages", hits)
        self._dirty = True
        self._sync(state)
        for g, wt in zip(self.groups, write_tbls):
            for node, rnode in zip(state.caches[g.key], row.caches[g.key], strict=True):
                paged_scatter_row(node, rnode, slot, wt)
        for key in self.state_keys:
            for node, rnode in zip(state.caches[key], row.caches[key], strict=True):
                _scatter_node(node, rnode, slot)
        state.position[slot:slot + 1] = row.position
        return state

    def free_row(self, state: DecodeState, slot: int) -> DecodeState:
        for g in self.groups:
            g.pool.free_row(slot)
        self._dirty = True  # pushed before the next table read/write
        return state

    def begin_admission(self) -> None:
        for g in self.groups:
            g.pool.reserved = 0

    def can_admit(self, n_tokens: int, prompt=None) -> bool:
        """Admission gated on free *pages*, not free slots: a ticket admits
        only when every group can map its content (+1 append slot) after
        prefix-sharing hits.  Approval reserves the pages so one admission
        round cannot over-commit the pool."""
        keys = self._keys(prompt)
        needed = []
        for g in self.groups:
            need = g.pool.peek_needed(n_tokens, keys)
            if g.pool.available() < need:
                if self.tracer.enabled:
                    self.tracer.emit(
                        "admit_refuse", cause="no_free_pages",
                        needed=need, available=g.pool.available())
                    self.tracer.inc("admit_refusals")
                return False
            needed.append(need)
        for g, need in zip(self.groups, needed):
            g.pool.reserved += need
        return True

    def prepare_step(self, state: DecodeState, lengths: dict[int, int], ahead: int):
        """Allocation-on-append + copy-on-write, before the decode step:
        every active row gets pages covering ``length + ahead`` tokens
        (``ahead`` = 1 plain decode, k+1 speculative) and private
        writability over the slots the step will write.  Rows the pool
        cannot serve are returned as ``failed`` — the engine parks a
        page-pressure victim and retries.  Forks made before a row failed
        are copied all the same (``PagePool.cow``)."""
        failed: list[int] = []
        copies: list[tuple[int, int, int]] = []  # (group, src, dst)
        for slot, ln in lengths.items():
            ok = True
            for gi, g in enumerate(self.groups):
                if not g.pool.ensure(slot, ln + ahead):
                    ok = False
                    break
                pairs, ok = g.pool.cow(slot, ln, ln + ahead)
                copies.extend((gi, s, d) for s, d in pairs)
                if pairs and self.tracer.enabled:
                    for s, d in pairs:
                        self.tracer.emit(
                            "cow_fork", slot=slot, cause="shared_page_write",
                            group=gi, src=s, dst=d)
                    self.tracer.inc("cow_forks", len(pairs))
                if not ok:
                    break
            if not ok:
                failed.append(slot)
        self._dirty = True
        self._sync(state)
        for gi, src, dst in copies:
            for node in state.caches[self.groups[gi].key]:
                copy_page_node(node, src, dst)
        return state, failed

    def tier_masks(self, lengths: dict[int, int]) -> tuple[list, list]:
        """Per group, the (P+1,) bool masks of the pages a tier pass now
        demotes (cold, above the controller's target) and measures (cold)."""
        pol, target = self.tier_ctrl.policy, self.tier_ctrl.target_keep
        demote_masks, shadow_masks = [], []
        for g in self.groups:
            demote = np.zeros(g.pool.n_pages + 1, bool)
            shadow = np.zeros(g.pool.n_pages + 1, bool)
            for p, age in g.pool.page_ages(lengths).items():
                if age < pol.cold_after:
                    continue
                shadow[p] = True
                if target is not None and g.pool.tier[p] > target:
                    demote[p] = True
            demote_masks.append(demote)
            shadow_masks.append(shadow)
        return demote_masks, shadow_masks

    def tier_tick(self, state: DecodeState, lengths: dict[int, int], step: int):
        """One demotion/measurement pass of the precision-tier loop, eager
        and between steps (one sync: the two residuals)."""
        tc = self.tier_ctrl
        if tc is None or not lengths:
            return state, None
        pol = tc.policy
        target, nxt = tc.target_keep, tc.next_keep
        demote_masks, shadow_masks = self.tier_masks(lengths)
        if not any(m.any() for m in shadow_masks):
            return state, None
        dev = state.position.device
        errs = []
        for g, demote, shadow in zip(self.groups, demote_masks, shadow_masks):
            errs.extend(tier_node(
                state.caches[g.key], torch.from_numpy(demote).to(dev),
                torch.from_numpy(shadow).to(dev), target, nxt, pol.rounding))
        errs = torch.stack(errs).reshape(-1, 2).cpu().numpy()  # the pass's one sync
        err = float(errs[:, 0].max())
        err_down = float(errs[:, 1].max())
        demoted = 0
        for g, mask in zip(self.groups, demote_masks):
            demoted += int(mask.sum())
            if target is not None:
                g.pool.tier[mask] = target
        decision = tc.observe(step, err, err_down)
        promoted = 0
        if decision > 0:
            # floor retreated: re-label every page demoted below it (lossy
            # demotion, label promotion — DESIGN.md tier invariant)
            floor = tc.target_keep if tc.target_keep is not None else HOT
            for g in self.groups:
                deep = g.pool.tier < floor
                promoted += int(deep.sum())
                g.pool.tier[deep] = floor
        return state, {
            "demoted": demoted, "promoted": promoted,
            "err": err, "err_down": err_down,
            "depth": tc.depth, "keep": target,
        }

    def page_stats(self) -> dict | None:
        total = used = cached = mapped = unique = 0
        shared_hits = cow = evic = 0
        mix: dict[str, int] = {}
        for g in self.groups:
            s = g.pool.stats()
            total += s["pages_total"]
            used += s["pages_used"]
            cached += s["pages_cached"]
            mapped += s["mapped_refs"]
            unique += s["unique_pages"]
            shared_hits += s["shared_hits"]
            cow += s["cow_copies"]
            evic += s["index_evictions"]
            for t, n in s["tier_mix"].items():
                mix[t] = mix.get(t, 0) + n
        return {
            "pages_total": total,
            "pages_used": used,
            "pages_cached": cached,
            "occupancy": used / total if total else 0.0,
            "sharing_ratio": 1.0 - unique / mapped if mapped else 0.0,
            "shared_hits": shared_hits,
            "cow_copies": cow,
            "index_evictions": evic,
            "tier_mix": mix,
            "dense_equiv_slots": self.dense_equiv_slots,
        }

    def describe(self) -> str:
        tiers = (self.tier_ctrl.describe() if self.tier_ctrl is not None
                 else "tiers off")
        pools = ", ".join(
            f"{g.pool.n_pages}p x {g.pool.ps}t (cap {g.cap})"
            for g in self.groups) or "no KV groups"
        return (f"paged cache: {self.slots} slots over pools [{pools}] "
                f"~= {self.dense_equiv_slots} dense slots of memory | "
                f"sharing {'on' if self.cfg.prefix_sharing else 'off'} | "
                f"{tiers}{_recurrent_note(self.axes)}")


def make_layout(cfg: CacheConfig, model, slots: int, max_len: int) -> KVLayout:
    """Layout factory for the engine: ``CacheConfig.layout`` selects."""
    if cfg.layout == "paged":
        return PagedLayout(model, slots, max_len, cfg)
    return DenseLayout(model, slots, max_len)
