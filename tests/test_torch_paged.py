"""The port's paged KV cache against the reference's, on the CPU at small
sizes: the cache functions (append, view, ring wrap, row scatter) bit for
bit for bf16 and int8 pools; ``PagePool`` event for event; the tier pass
(``tier_node``, the quantize kernel's plain version against the reference's
Pallas kernel in interpret mode) bit for bit; the tier controller's
timeline; and the layout's own invariants — a ring wrap through shared
prompt pages forks them instead of writing them, a parked row scatters back
bit-exactly, and the pools are written in place, never rebuilt."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.adapt.pages import PageTierController as JPageTierController
from repro.adapt.pages import PageTierPolicy as JPageTierPolicy
from repro.models import layers as jl
from repro.serve.paged import PagePool as JPagePool
from repro.serve.paged import tier_node as j_tier_node

from repro_torch.adapt import PageTierController, PageTierPolicy
from repro_torch.models import layers as tl
from repro_torch.models.lm import state_leaves
from repro_torch.serve import CacheConfig, PagedLayout, PagePool
from repro_torch.serve.paged import restore_pools, save_pools, tier_node

from test_torch_common import make_pair


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _pair_caches(batch, cap, n_kv, hd, dtype, ps, n_pages, tbl):
    """The same empty paged node in both packages, with table ``tbl``."""
    j = jl.paged_cache_init(batch, cap, n_kv, hd, dtype, n_pages=n_pages, page_size=ps)
    j = dataclasses.replace(j, page_tbl=jnp.asarray(tbl))
    t = tl.paged_cache_init(batch, cap, n_kv, hd, dtype, n_pages=n_pages, page_size=ps)
    t.page_tbl.copy_(torch.from_numpy(tbl))
    return j, t


def _assert_nodes_equal(j, t):
    for name in ("k_pool", "v_pool", "k_scale", "v_scale", "page_tbl", "pos", "length"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)


def _permuted_table(batch, per_row, seed):
    """Private pages per row, in a shuffled pool order (no sharing)."""
    pages = np.random.default_rng(seed).permutation(batch * per_row) + 1
    return pages.reshape(batch, per_row).astype(np.int32)


def _kv(rng, b, s, n_kv, hd):
    return rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_append_and_view_equal_the_reference_through_a_ring_wrap(dtype):
    """A 3-token append, then single-token appends far past the capacity:
    pools, positions, lengths and the view equal the reference's bit for
    bit, and the view equals the dense ring cache at every valid slot."""
    batch, cap, n_kv, hd, ps = 2, 8, 2, 4, 4
    tbl = _permuted_table(batch, cap // ps, seed=1)
    j, t = _pair_caches(batch, cap, n_kv, hd, dtype, ps, batch * cap // ps, tbl)
    d = tl.kv_cache_init(batch, cap, n_kv, hd, dtype, per_slot=True)
    pools = [t.k_pool, t.v_pool]
    rng = np.random.default_rng(2)
    for s in [3] + [1] * 11:  # 14 tokens into 8 slots: the ring wraps
        k, v = _kv(rng, batch, s, n_kv, hd), _kv(rng, batch, s, n_kv, hd)
        j = jl.paged_append(j, jnp.asarray(k), jnp.asarray(v))
        t = tl.paged_append(t, torch.from_numpy(k), torch.from_numpy(v))
        d = tl.kv_cache_append_slots(d, torch.from_numpy(k), torch.from_numpy(v))
        _assert_nodes_equal(j, t)
    assert [t.k_pool, t.v_pool] == pools  # the same tensors, written in place
    for got, want, dense in zip(tl.paged_view(t), jl.paged_view(j),
                                (d.k, d.v, d.k_scale, d.v_scale)):
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(got), _np(dense))  # all slots valid
    assert int(t.length.min()) == 14 and (t.pos >= 0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_scatter_rows_roundtrips_the_view_as_the_reference_does(dtype):
    """``paged_scatter_rows`` writes each row's virtual content back through
    the table: the view round-trips, and new content lands where the
    reference puts it (pools bit-equal)."""
    batch, cap, n_kv, hd, ps = 2, 8, 1, 4, 4
    tbl = _permuted_table(batch, cap // ps, seed=3)
    j, t = _pair_caches(batch, cap, n_kv, hd, dtype, ps, batch * cap // ps, tbl)
    rng = np.random.default_rng(4)
    for _ in range(6):
        k = _kv(rng, batch, 1, n_kv, hd)
        j = jl.paged_append(j, jnp.asarray(k), jnp.asarray(k))
        t = tl.paged_append(t, torch.from_numpy(k), torch.from_numpy(k))
    view = [x.clone() if x is not None else None for x in tl.paged_view(t)]
    t = tl.paged_scatter_rows(t, *view, t.pos, t.length)
    for a, b in zip(tl.paged_view(t), view):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    # fresh content through both packages' scatter
    fresh = tl.paged_view(tl.paged_append(t, torch.ones(batch, 1, n_kv, hd),
                                          torch.ones(batch, 1, n_kv, hd)))
    jfresh = [None if x is None else jnp.asarray(_np(x)).astype(y.dtype)
              for x, y in zip(fresh, jl.paged_view(j))]
    j = jl.paged_scatter_rows(j, *jfresh, j.pos, j.length)
    t = tl.paged_scatter_rows(t, *fresh, t.pos, t.length)
    _assert_nodes_equal(j, t)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_readonly_append_sees_the_new_rows_and_writes_no_pool(dtype):
    """The probe's append places the new rows into the view only: its view
    equals append-then-view, and every pool stays bit-identical."""
    batch, cap, n_kv, hd, ps = 3, 8, 2, 4, 4
    tbl = _permuted_table(batch, cap // ps, seed=5)
    _, t = _pair_caches(batch, cap, n_kv, hd, dtype, ps, batch * cap // ps, tbl)
    rng = np.random.default_rng(6)
    for _ in range(5):
        k = torch.from_numpy(_kv(rng, batch, 1, n_kv, hd))
        t = tl.paged_append(t, k, k)
    before = [x.clone() for x in _pool_leaves(t)]
    k, v = (torch.from_numpy(_kv(rng, batch, 1, n_kv, hd)) for _ in range(2))
    node, view = tl.paged_append_readonly(t, k, v)
    assert all(torch.equal(a, b) for a, b in zip(_pool_leaves(t), before))
    written = tl.paged_append(t, k, v)
    for a, b in zip(view, tl.paged_view(written)):
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(node.pos, written.pos) and torch.equal(node.length, written.length)


def _pool_leaves(node):
    return [getattr(node, f) for f in tl.POOL_FIELDS if getattr(node, f) is not None]


def test_saved_slots_restore_what_appends_overwrite():
    """``paged_save_slots`` + ``paged_restore_slots`` undo ``n`` one-token
    appends bit for bit, ring wrap included; a ``where`` mask restores only
    the chosen entries."""
    batch, cap, n_kv, hd, ps = 2, 8, 1, 4, 4
    tbl = _permuted_table(batch, cap // ps, seed=7)
    _, t = _pair_caches(batch, cap, n_kv, hd, "bfloat16", ps, batch * cap // ps, tbl)
    rng = np.random.default_rng(8)
    for _ in range(6):
        k = torch.from_numpy(_kv(rng, batch, 1, n_kv, hd))
        t = tl.paged_append(t, k, k)
    before = t.k_pool.clone()
    saved = tl.paged_save_slots(t, 3)  # slots 6, 7 and (wrapped) 0
    node = t
    for _ in range(3):
        k = torch.from_numpy(_kv(rng, batch, 1, n_kv, hd))
        node = tl.paged_append(node, k, k)
    after = t.k_pool.clone()
    assert not torch.equal(after, before)
    keep = torch.tensor([[True, False, True], [False, False, False]])
    tl.paged_restore_slots(t, saved, keep)
    pages, off, _ = saved
    for b in range(batch):
        for i in range(3):
            want = before if keep[b, i] else after
            assert torch.equal(t.k_pool[pages[b, i], off[b, i]],
                               want[pages[b, i], off[b, i]])
    tl.paged_restore_slots(t, saved)
    assert torch.equal(t.k_pool, before)


# ---------------------------------------------------------------------------
# PagePool, event for event
# ---------------------------------------------------------------------------


def _keys(prompt, ps):
    a = np.asarray(prompt, np.int32)
    return [a[: (j + 1) * ps].tobytes() for j in range(len(a) // ps)]


def _pool_state(pool):
    return dict(tbl=pool.tbl.tolist(), ref=pool.ref.tolist(), tier=pool.tier.tolist(),
                free=list(pool.free), index=dict(pool.index), page_key=dict(pool.page_key),
                cached=list(pool.cached), reserved=pool.reserved,
                available=pool.available(), stats=pool.stats())


def _ret(x):
    return x.tolist() if isinstance(x, np.ndarray) else x


SCRIPTS = {
    # shared prefixes, copy-on-write forks, completion into the LRU cache
    "sharing": [
        ("attach", 0, 8, "a"), ("attach", 1, 8, "a"), ("attach", 2, 5, "b"),
        ("peek_needed", 8, "a"), ("peek_needed", 12, "c"),
        ("ensure", 0, 9), ("cow", 1, 0, 4), ("cow", 1, 0, 4), ("cow", 0, 4, 8),
        ("tier", 3, 5), ("cow", 2, 4, 6), ("page_ages", {0: 9, 1: 8, 2: 5}),
        ("free_row", 0), ("free_row", 1), ("peek_needed", 8, "a"),
        ("attach", 0, 8, "a"), ("ensure", 0, 12), ("free_row", 2),
    ],
    # exhaustion: allocation fails, the LRU prefix cache is reclaimed, and
    # reservations gate what is available
    "exhaustion": [
        ("attach", 0, 4, "a"), ("free_row", 0), ("reserve", 2),
        ("attach", 1, 8, None), ("reserve", 0), ("attach", 2, 9, "c"),
        ("ensure", 1, 16), ("ensure", 2, 16), ("cow", 2, 0, 4),
        ("free_row", 1), ("attach", 0, 4, "a"), ("ensure", 2, 16),
        ("page_ages", {0: 4, 2: 20}), ("free_row", 2), ("free_row", 0),
    ],
}
PROMPTS = {"a": [7] * 8 + [3] * 4, "b": [5] * 5, "c": [2] * 12}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_page_pool_equals_the_reference_event_for_event(script):
    ps = 4
    pools = (JPagePool(7, page_size=ps, cap=16, rows=3), PagePool(7, page_size=ps, cap=16, rows=3))
    for event in SCRIPTS[script]:
        op, *args = event
        results = []
        for pool in pools:
            if op in ("attach", "peek_needed"):
                *head, key = args
                keys = None if key is None else _keys(PROMPTS[key], ps)
                results.append(_ret(getattr(pool, op)(*head, keys)))
            elif op == "reserve":
                pool.reserved = args[0]
                results.append(None)
            elif op == "tier":  # a tier pass relabels a page
                pool.tier[args[0]] = args[1]
                results.append(None)
            elif op == "cow" and pool is pools[1]:
                # the port also returns the forks made before an exhaustion
                pairs, ok = pool.cow(*args)
                results.append(pairs if ok else None)
            else:
                results.append(_ret(getattr(pool, op)(*args)))
        assert results[1] == results[0], event
        assert _pool_state(pools[1]) == _pool_state(pools[0]), event
    s = pools[1].stats()
    assert s["shared_hits"] + s["cow_copies"] + s["index_evictions"] > 0


def test_page_pool_refuses_a_pool_smaller_than_one_row():
    with pytest.raises(ValueError, match="one full row"):
        PagePool(3, page_size=4, cap=16, rows=2)
    assert PagePool(8, page_size=4, cap=8, rows=2).pages_for(100) == 2  # ring clamp


# ---------------------------------------------------------------------------
# the tier pass and its controller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep,next_keep,rounding", [
    (5, 3, "trunc"), (None, 5, "trunc"), (3, None, "grte"), (2, 1, "rne")])
def test_tier_node_equals_the_reference_bit_for_bit(keep, next_keep, rounding):
    """The same bf16 pools (two layers), masks and keep: the port's pass,
    one layer at a time, leaves the reference's demoted pools bit for bit
    and the same residuals (to f32 rounding)."""
    layers, pages, ps, n_kv, hd = 2, 7, 4, 2, 8
    rng = np.random.default_rng(9)
    k = rng.standard_normal((layers, pages, ps, n_kv, hd)).astype(np.float32)
    v = (rng.standard_normal((layers, pages, ps, n_kv, hd)) * 3).astype(np.float32)
    demote = np.array([False, True, False, True, True, False, False])
    shadow = np.array([False, True, True, False, True, False, True])
    jnode = jl.PagedKVCache(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), None, None,
        jnp.zeros((layers, 1, 1), jnp.int32), jnp.zeros((layers, 1, 1), jnp.int32),
        jnp.zeros((layers, 1), jnp.int32))
    jout, jerr, jerr_down = j_tier_node(jnode, jnp.asarray(demote), jnp.asarray(shadow),
                                        keep, next_keep, rounding)
    nodes = [tl.PagedKVCache(torch.from_numpy(k[li]).to(torch.bfloat16),
                             torch.from_numpy(v[li]).to(torch.bfloat16), None, None,
                             torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros((1,), dtype=torch.int32)) for li in range(layers)]
    pools = [n.k_pool for n in nodes]
    err, err_down = tier_node(nodes, torch.from_numpy(demote), torch.from_numpy(shadow),
                              keep, next_keep, rounding)
    assert [n.k_pool for n in nodes] == pools  # in place
    for li, node in enumerate(nodes):
        np.testing.assert_array_equal(_np(node.k_pool), _np(jout.k_pool[li]))
        np.testing.assert_array_equal(_np(node.v_pool), _np(jout.v_pool[li]))
    changed = not np.array_equal(_np(nodes[0].k_pool), _np(jnode.k_pool[0]))
    assert changed == (keep is not None)
    for got, want in ((err, jerr), (err_down, jerr_down)):
        assert abs(float(got) - float(want)) <= 2.0**-23 * abs(float(want))
    assert float(err_down) > 0


def test_tier_controller_timeline_equals_the_reference():
    """The same observations drive both controllers through the same
    depths, targets and decisions (closed loop and open loop)."""
    rng = np.random.default_rng(10)
    for budget in (0.1, None):
        kw = dict(levels=(6, 4, 2), budget=budget, cooldown=1, cold_after=4, every=2)
        j, t = JPageTierController(JPageTierPolicy(**kw)), PageTierController(PageTierPolicy(**kw))
        for step in range(40):
            err, err_down = (float(x) for x in rng.uniform(0.0, 0.2, 2))
            assert t.observe(step, err, err_down) == j.observe(step, err, err_down), step
            assert (t.depth, t.target_keep, t.next_keep, t.promotions, t.demotions) == (
                j.depth, j.target_keep, j.next_keep, j.promotions, j.demotions)
        assert t.describe() == j.describe()
    with pytest.raises(ValueError, match="descend"):
        PageTierPolicy(levels=(3, 5))


# ---------------------------------------------------------------------------
# the layout on the port's model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    _, _, model, params = make_pair("native_f32", n_layers=2)
    return model, params


def _layout(model, slots=2, max_len=16, **kw):
    layout = PagedLayout(model, slots, max_len, CacheConfig(layout="paged", page_size=4, **kw))
    return layout, layout.init()


def _held_pages(layout):
    """Pages no row may write: shared (ref > 1) or held by the prefix index."""
    pool = layout.groups[0].pool
    return sorted({p for p in range(1, pool.n_pages + 1)
                   if pool.ref[p] > 1 or p in pool.page_key})


def test_ring_wrap_through_shared_prompt_pages_forks_them(tiny):
    """Two rows share a 12-token prompt prefix in a 16-slot ring; decoding
    past the capacity wraps onto the shared pages, which fork instead of
    being written: the shared and index-held pages keep their bits through
    every step, and every row's logits equal a dense cache's, wrap and all."""
    model, params = tiny
    layout, state = _layout(model)
    prompt = np.arange(12, dtype=np.int32) + 3
    dense = model.init_decode_state(2, 16, per_slot=True)
    for slot in range(2):
        solo0 = model.init_decode_state(1, 16, per_slot=True)
        _, solo = model.decode_step(params, torch.from_numpy(prompt[None]), solo0)
        layout.scatter_row(state, solo, slot, prompt=prompt)
        for key in dense.caches:
            for dn, sn in zip(dense.caches[key], solo.caches[key]):
                for f in ("k", "v", "pos", "length"):
                    getattr(dn, f)[slot:slot + 1] = getattr(sn, f)
    dense.position[:] = 12
    assert layout.groups[0].pool.shared_hits == 3
    rng = np.random.default_rng(11)
    for step in range(8):  # lengths 12 .. 20 > cap 16
        held = _held_pages(layout)
        snap = {p: [n.k_pool[p].clone() for n in state.caches["seg0_dense"]] for p in held}
        state, failed = layout.prepare_step(state, {0: 12 + step, 1: 12 + step}, ahead=1)
        assert not failed
        tok = torch.from_numpy(rng.integers(0, 512, (2, 1)).astype(np.int32))
        logits, new = model.decode_step(params, tok, state)
        dlogits, dense = model.decode_step(params, tok, dense)
        assert torch.equal(logits, dlogits), step
        state.caches = new.caches
        state.position = new.position
        for p, pages in snap.items():
            for n, page in zip(state.caches["seg0_dense"], pages):
                assert torch.equal(n.k_pool[p], page), (step, p)
    assert layout.groups[0].pool.cow_copies >= 2  # both rows forked on the wrap


def test_a_fork_made_before_the_pool_ran_dry_still_gets_its_page(tiny):
    """A speculative row whose k+1 appends wrap over two shared prompt pages,
    in a pool with room for one fork: the first page forks, the second
    cannot, and the row fails.  The fork already made is copied all the
    same, so once another row is parked and the step retried (where the
    fork counts as the row's own page) the row still holds its content bit
    for bit."""
    model, params = tiny
    layout = PagedLayout(model, 3, 10, CacheConfig(layout="paged", page_size=2, pool_pages=10))
    state = layout.init()
    prompt = np.arange(9, dtype=np.int32) + 5  # 4 full shared pages + 1 private each
    other = np.arange(4, dtype=np.int32) + 100  # 3 pages of its own
    for slot, p in ((0, prompt), (1, prompt), (2, other)):
        _, solo = model.decode_step(params, torch.from_numpy(p[None]),
                                    model.init_decode_state(1, 10, per_slot=True))
        layout.scatter_row(state, solo, slot, prompt=p)
    pool = layout.groups[0].pool
    assert pool.shared_hits == 4 and len(pool.free) == 1
    before = layout.gather_row(state, 0)
    # slots 9, 0, 1, 2: the private last page, then shared pages 0 and 1
    state, failed = layout.prepare_step(state, {0: 9}, ahead=4)
    assert failed == [0] and pool.cow_copies == 1
    layout.free_row(state, 1)  # the engine parks a page-pressure victim
    state, failed = layout.prepare_step(state, {0: 9}, ahead=4)
    assert not failed and pool.cow_copies == 2
    after = layout.gather_row(state, 0)
    for b, a in zip(before.caches["seg0_dense"], after.caches["seg0_dense"]):
        assert torch.equal(a.pos, b.pos) and torch.equal(a.length, b.length)
        valid = b.pos[0] >= 0
        assert torch.equal(a.k[0][valid], b.k[0][valid])
        assert torch.equal(a.v[0][valid], b.v[0][valid])


def test_park_and_resume_roundtrip_the_row_bit_exactly(tiny):
    """gather_row -> free_row -> scatter_row into another slot restores the
    row's dense content exactly; pools and tables keep their tensors."""
    model, params = tiny
    layout, state = _layout(model, slots=3)
    ptrs = [x.data_ptr() for x in state_leaves(state)]
    prompt = np.arange(9, dtype=np.int32) + 1
    _, solo = model.decode_step(params, torch.from_numpy(prompt[None]),
                                model.init_decode_state(1, 16, per_slot=True))
    assert layout.scatter_row(state, solo, 0, prompt=prompt) is state
    row = layout.gather_row(state, 0)
    layout.free_row(state, 0)
    layout.scatter_row(state, row, 2, length=9)
    back = layout.gather_row(state, 2)
    for a, b in zip(state_leaves(back), state_leaves(row)):
        assert torch.equal(a, b)
    valid = solo.caches["seg0_dense"][0].pos[0] >= 0
    assert torch.equal(back.caches["seg0_dense"][0].k[0][valid],
                       solo.caches["seg0_dense"][0].k[0][valid])
    assert [x.data_ptr() for x in state_leaves(state)] == ptrs
    tbl = state.caches["seg0_dense"][0].page_tbl
    assert all(n.page_tbl is tbl for n in state.caches["seg0_dense"])  # one table per group
    assert (tbl[0] == -1).all() and (tbl[2] >= 0).any()


def test_saved_pools_restore_what_a_step_appends(tiny):
    """What a captured step's warm-up and a speculative round rely on: a
    step's in-place appends to every pool of the state are undone bit for
    bit."""
    model, params = tiny
    layout, state = _layout(model)
    prompt = np.arange(6, dtype=np.int32)
    _, solo = model.decode_step(params, torch.from_numpy(prompt[None]),
                                model.init_decode_state(1, 16, per_slot=True))
    layout.scatter_row(state, solo, 0, prompt=prompt)
    layout.prepare_step(state, {0: 6}, ahead=3)
    before = [x.clone() for x in state_leaves(state)]
    saved = save_pools(state, 3)
    st = state
    for _ in range(3):
        _, st = model.decode_step(params, torch.ones((2, 1), dtype=torch.int32), st)
    assert not all(torch.equal(a, b) for a, b in zip(state_leaves(state), before))
    restore_pools(state, saved)
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(state), before))


def test_spec_rollback_restores_rejected_writes_that_wrapped_onto_live_slots(tiny):
    """The paged twin of the dense rollback across a ring wrap: rows two
    slots from full share a prompt prefix; four verify appends wrap onto
    their first page (forked beforehand) and rows 0-1 accept 0 and 2 of
    them.  After the rollback every valid slot equals the dense rollback's
    bit for bit — the rejected wrapped writes are undone — and the page the
    rows shared (still held by the prefix index) kept its bits."""
    from repro_torch.serve.paged import DenseLayout, compute_axes
    from repro_torch.spec.rollout import rollback, snapshot

    model, params = tiny
    rng = np.random.default_rng(13)
    prefix = rng.integers(0, 512, 4).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 512, 4).astype(np.int32)])
               for _ in range(3)]
    inputs = torch.as_tensor(rng.integers(0, 512, (3, 4)).astype(np.int32))
    layout = PagedLayout(model, 3, 10, CacheConfig(layout="paged", page_size=2))
    dense_layout = DenseLayout(model, 3, 10)
    paged, dense = layout.init(), dense_layout.init()
    for slot, prompt in enumerate(prompts):
        _, solo = model.decode_step(params, torch.from_numpy(prompt[None]),
                                    model.init_decode_state(1, 10, per_slot=True))
        layout.scatter_row(paged, solo, slot, prompt=prompt)
        dense = dense_layout.scatter_row(dense, solo, slot)
    layout.free_row(paged, 2)  # an inactive row: its table is cleared
    paged, failed = layout.prepare_step(paged, {0: 8, 1: 8}, ahead=4)
    assert not failed and layout.groups[0].pool.cow_copies == 2
    shared = int(layout.groups[0].pool.index[prefix[:2].tobytes()])
    page_before = paged.caches["seg0_dense"][0].k_pool[shared].clone()
    n_acc = torch.tensor([0, 2, 3], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    rolled = {}
    for name, state, axes in (("paged", paged, layout.axes),
                              ("dense", dense, compute_axes(dense))):
        saved = save_pools(state, 4)
        chain, st = [], state
        for i in range(4):
            _, st = model.decode_step(params, inputs[:, i:i + 1], st)
            chain.append(snapshot(st))
        rolled[name] = rollback(axes, state, st, chain, n_acc, active, saved)
    assert bool((rolled["dense"].caches["seg0_dense"][0].pos[:2, :2] == torch.tensor(
        [[0, 1], [10, 1]])).all())  # row 1 kept its wrapped position 10
    for slot in (0, 1):
        p = layout.gather_row(rolled["paged"], slot)
        d = dense_layout.gather_row(rolled["dense"], slot)
        for pn, dn in zip(p.caches["seg0_dense"], d.caches["seg0_dense"]):
            assert torch.equal(pn.pos, dn.pos) and torch.equal(pn.length, dn.length)
            valid = dn.pos[0] >= 0
            assert torch.equal(pn.k[0][valid], dn.k[0][valid]), slot
            assert torch.equal(pn.v[0][valid], dn.v[0][valid]), slot
    assert torch.equal(paged.caches["seg0_dense"][0].k_pool[shared], page_before)
