"""The speculative round: draft k cheap, verify k+1 exact, roll back.

One round over the serve engine's slot array (B = slots):

  1. **draft** — ``k`` single-token substeps of the same decode step under
     the *draft* mode table (``bind_modes``: host ints, or the device
     scalars the engine's captured round reads as data, so changing the
     draft depth builds nothing).  The draft runs on a scratch state: the
     decode step never modifies a dense state it is given (every dense
     cache write is out of place), so its low-precision KV writes are never
     kept.  A paged state's pools are written in place: the ``k + 1`` slots
     per row that the round appends to are saved before the draft and put
     back after it.
  2. **verify** — ``k + 1`` substeps of the *exact baseline step* (static
     plans, or the live adaptive table when the engine adapts) from the same
     pre-round state, over the inputs ``[t0, d1..dk]``, one token at a time.
     Greedy argmax at position ``i`` is precisely the token the
     non-speculative engine would have emitted after the first ``i`` inputs
     — the same kernels, shapes and summation order — so the longest prefix
     where draft and verify agree, plus verify's correction token at the
     first disagreement, *is* the baseline token sequence (identical
     outputs).
  3. **rollback-select** — one select restores every slot to its accepted
     prefix, per leaf kind:

       * KV ``length`` / ``DecodeState.position``: arithmetic
         (``len0 + 1 + n_acc``), the position gathered per slot from the
         per-substep snapshots;
       * KV rows (``k``/``v``/scales/``pos``): entries the verify chain
         wrote past the accepted point are restored from the pre-round
         cache by a ``pos > len0 + n_acc`` mask — this also repairs ring
         rows that a write past the cache's capacity landed on (the
         hybrid's local-window ring).  For paged pools the pre-round
         content is the saved slots, written back where the mask holds (the
         reference mixes whole-row views and scatters them back; only the
         appended slots can differ);
       * recurrent states (``SSMState`` / ``RGLRUState``: the SSM, RG-LRU
         and conv states): no length arithmetic can repair a state, so every
         verify substep's state is kept (``snapshot``) and each slot takes
         the one at its ``n_acc``, bit for bit;
       * inactive rows keep their exact pre-round state (the engine's
         masking invariant).

Where the reference scans the substeps inside one compiled function, the
round here is a Python loop of ``k`` draft and ``k + 1`` verify substeps;
drafts, acceptance and the rollback stay on the device, so the engine
captures the whole round as one CUDA graph (repro_torch.serve.graphs) and
reads its results with ONE host sync.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.adapt import bind_modes
from repro_torch.models.layers import KVCache, PagedKVCache, paged_restore_slots
from repro_torch.models.lm import DecodeState
from repro_torch.serve.engine import row_select as _sel  # the masked-step freeze
from repro_torch.serve.paged import restore_pools, save_pools


def _gather_substep(stacked: torch.Tensor, n_acc: torch.Tensor, ax: int) -> torch.Tensor:
    """Pick snapshot ``n_acc[b]`` per slot from a (k+1, ...)-stacked leaf
    whose unstacked batch axis is ``ax``."""
    shape = [1] * stacked.dim()
    shape[ax + 1] = n_acc.shape[0]
    idx = n_acc.reshape(shape).long().expand(1, *stacked.shape[1:])
    return torch.take_along_dim(stacked, idx, dim=0)[0]


def _is_kv(node) -> bool:
    """Cache nodes of either layout — left out of the snapshots, rolled back
    by the pos-mask select rather than the substep stack."""
    return isinstance(node, (KVCache, PagedKVCache))


def snapshot(state: DecodeState) -> DecodeState:
    """The rollback payload of one verify substep: every leaf except the KV
    caches (those roll back via length arithmetic + the pos-mask select, so
    keeping them per substep would be k+1 copies of decode memory) — the
    position and the recurrent states."""
    return DecodeState(
        caches={key: nodes for key, nodes in state.caches.items() if not _is_kv(nodes[0])},
        position=state.position, enc_out=state.enc_out)


def _roll_state(axn, s0, snaps: list, n_acc: torch.Tensor, active: torch.Tensor):
    """A recurrent-state node rolled back: per slot, the verify substep's
    state at ``n_acc`` (from the stack of ``snaps``, one node per substep);
    inactive rows keep ``s0``."""
    def field(name):
        old = getattr(s0, name)
        if old is None:
            return None
        ax = getattr(axn, name)
        stacked = torch.stack([getattr(n, name) for n in snaps])
        return _sel(ax, _gather_substep(stacked, n_acc, ax), old, active)

    return type(s0)(*[field(f.name) for f in dataclasses.fields(s0)])


def _roll_kv(axn: KVCache, c0: KVCache, cf: KVCache, n_acc: torch.Tensor,
             active: torch.Tensor) -> KVCache:
    """Roll one KV cache back to its accepted prefix.

    ``axn`` carries the per-leaf batch axes; ``c0``/``cf`` are the pre-round
    and post-verify caches.  Entries with a stored position past the last
    accepted token were written by rejected substeps: their rows (and ring
    slots that such a write overwrote) are restored from ``c0``.
    """
    shape = [1] * c0.length.dim()
    shape[axn.length] = n_acc.shape[0]
    keep_last = c0.length + n_acc.reshape(shape)  # position of last kept token
    mask = cf.pos > keep_last[..., None]  # (B, Smax): rejected writes

    def mix(fresh, old):
        if fresh is None:
            return None
        m = mask.reshape(mask.shape + (1,) * (fresh.dim() - mask.dim()))
        return torch.where(m, old, fresh)

    rolled = KVCache(
        k=mix(cf.k, c0.k),
        v=mix(cf.v, c0.v),
        k_scale=mix(cf.k_scale, c0.k_scale),
        v_scale=mix(cf.v_scale, c0.v_scale),
        pos=torch.where(mask, c0.pos, cf.pos),
        length=(keep_last + 1).to(c0.length.dtype),
    )
    return _map_kv(lambda ax, new, old: _sel(ax, new, old, active), axn, rolled, c0)


def _roll_paged(axn: PagedKVCache, c0: PagedKVCache, cf: PagedKVCache,
                n_acc: torch.Tensor, active: torch.Tensor, saved: tuple) -> PagedKVCache:
    """Paged twin of :func:`_roll_kv`.  The verify chain appended through
    the page table (the layout mapped and copy-on-write forked every page
    of the k+1 appends beforehand), so rejected entries live in private
    pages: the saved pre-round content goes back where a substep past the
    accepted point wrote, for active rows (inactive rows wrote scratch).
    Per-row leaves (pos/length) then freeze inactive rows via the usual
    select; pool and table leaves are SHARED."""
    keep_last = c0.length + n_acc  # position of last kept token
    n = saved[0].shape[1]
    written = c0.length[:, None] + torch.arange(n, device=n_acc.device)  # (B, k+1)
    paged_restore_slots(cf, saved, (written > keep_last[:, None]) & active[:, None])
    mask = cf.pos > keep_last[:, None]
    rolled = dataclasses.replace(cf, pos=torch.where(mask, c0.pos, cf.pos),
                                 length=(keep_last + 1).to(c0.length.dtype))
    return _map_kv(lambda ax, new, old: _sel(ax, new, old, active), axn, rolled, c0)


def _map_kv(fn, *nodes):
    """``fn(leaf, ...)`` over the fields of cache nodes of one layout (a
    ``None`` field, such as the scales of a bf16 cache, stays ``None``)."""
    def field(name):
        leaves = [getattr(n, name) for n in nodes]
        return None if any(x is None for x in leaves) else fn(*leaves)

    return type(nodes[0])(*[field(f.name) for f in dataclasses.fields(nodes[0])])


def rollback(axes: DecodeState, state0: DecodeState, state_fin: DecodeState,
             snaps: list[DecodeState], n_acc: torch.Tensor,
             active: torch.Tensor, saved: dict | None = None) -> DecodeState:
    """One rollback-select over the whole decode state (``saved``: the
    paged nodes' pre-round slots, ``serve.paged.save_pools``; a dense
    state needs none)."""
    def roll(key, li, axn, c0, cf):
        if isinstance(c0, PagedKVCache):
            return _roll_paged(axn, c0, cf, n_acc, active, saved[id(c0)])
        if isinstance(c0, KVCache):
            return _roll_kv(axn, c0, cf, n_acc, active)
        return _roll_state(axn, c0, [s.caches[key][li] for s in snaps], n_acc, active)

    caches = {
        key: [roll(key, li, axn, c0, cf) for li, (axn, c0, cf) in enumerate(
            zip(axes.caches[key], layers, state_fin.caches[key]))]
        for key, layers in state0.caches.items()}
    stacked = torch.stack([s.position for s in snaps])
    position = _sel(axes.position, _gather_substep(stacked, n_acc, axes.position),
                    state0.position, active)
    return DecodeState(caches=caches, position=position, enc_out=state0.enc_out)


def build_spec_round(model, axes: DecodeState, k: int, modal_verify: bool):
    """Build the round function for ``model``.

    ``axes``: the engine's per-leaf batch-axis tree (``layout.axes``).
    ``modal_verify``: bind the verify substeps to the engine's live mode
    table (the adaptive engines' baseline is the modal step); when False the
    verify substeps run the static-plan path — the same step the plain
    engine decodes with.

    Returned signature::

        round_fn(params, tokens, state, active, draft_modes, verify_modes)
            -> (drafts (k, B), greedy (k+1, B), n_acc (B,), new_state)

    all on the device; nothing in the round waits for the device.
    """
    if k < 1:
        raise ValueError(f"draft depth k must be >= 1, got {k}")

    def argmax_last(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def round_fn(params, tokens, state, active, draft_modes, verify_modes):
        saved = save_pools(state, k + 1)
        # -- draft: k cheap-mode substeps on a scratch state ----------------
        drafts = []
        tok, st = tokens, state
        with bind_modes(draft_modes):
            for _ in range(k):
                logits, st = model.decode_step(params, tok, st)
                nxt = argmax_last(logits)
                drafts.append(nxt)
                tok = nxt[:, None]
        drafts = torch.stack(drafts)  # (k, B)
        restore_pools(state, saved)  # undo the draft's pool writes

        # -- verify: k+1 exact baseline substeps from the pre-round state ---
        inputs = torch.cat([tokens.to(torch.int32), drafts.T], dim=1)  # (B, k+1)
        greedy, snaps = [], []
        st = state
        with bind_modes(verify_modes) if modal_verify else contextlib.nullcontext():
            for i in range(k + 1):
                logits, st = model.decode_step(params, inputs[:, i:i + 1], st)
                greedy.append(argmax_last(logits))
                snaps.append(snapshot(st))
        greedy = torch.stack(greedy)  # (k+1, B)

        # -- accept the longest agreeing prefix, roll back the rest ---------
        match = (drafts == greedy[:-1]).to(torch.int32)  # (k, B)
        n_acc = torch.cumprod(match, dim=0).sum(dim=0).to(torch.int32)  # in [0, k]
        new_state = rollback(axes, state, st, snaps, n_acc, active, saved)
        return drafts, greedy, n_acc, new_state

    return round_fn


#: windowed draft/verify agreement below this rate is a rejection storm —
#: the draft table is too cheap for the current token distribution and the
#: acceptance controller should be pulling the shift shallower
REJECT_STORM_RATE = 0.25


def trace_round(tracer, span, *, k: int, n_active: int, agreed: int,
                emitted: int) -> None:
    """Complete one speculative round's trace record (repro_torch.obs): the
    round's ``spec_round`` span (``Tracer.span``, already ended, so its
    event carries the round's ``dur_ms``) gets the round's counts.

    ``agreed`` is raw draft/verify agreement (what the acceptance controller
    sees), ``emitted`` the tokens that actually left the engine after budget
    clamping.  A round whose acceptance rate drops below
    :data:`REJECT_STORM_RATE` is stamped ``cause="reject_storm"`` so draft
    collapses are findable in the trace without replaying the counters."""
    if not tracer.enabled:
        return
    drafted = k * n_active
    rate = agreed / drafted if drafted else None
    if rate is not None and rate < REJECT_STORM_RATE:
        span.event.cause = "reject_storm"
    span.data.update(n_active=n_active, drafted=drafted, agreed=agreed,
                     emitted=emitted, accept_rate=rate)
    tracer.inc("spec_rounds")
    tracer.inc("spec_drafted", drafted)
    tracer.inc("spec_agreed", agreed)
    if rate is not None and rate < REJECT_STORM_RATE:
        tracer.inc("spec_reject_storms")
