"""The serving engine over the port's paged KV cache, on the CPU at the smoke
size (2 layers, d_model 128, vocab 512): paged serving gives the dense
layout's tokens (plain, adaptive and speculative steps, bf16 and int8
caches, shared prefixes, page-pressure parking, tenancy preemption), agrees
with the reference's paged engine under the margin rule of
``test_torch_serve``, and runs precision tiers; and the invariants of pools
that a step writes in place — the probe leaves every pool bit-identical, no
shared or index-held page changes across steps, ring wraps and speculative
rounds, and the state's tensors are never rebound.  On the CPU the engine's
compiled steps run eagerly on the same static buffers; capture and replay
need the card (``chip_smoke.py --phases device,serve_paged``)."""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

from repro.adapt.pages import PageTierPolicy as JPageTierPolicy
from repro.serve import CacheConfig as JCacheConfig
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest

from repro_torch.adapt import SLO, PageTierPolicy
from repro_torch.core.precision import Mode
from repro_torch.launch import serve as launch_serve
from repro_torch.models.lm import state_leaves
from repro_torch.plan import MODE_REL_ERROR
from repro_torch.serve import (
    AdaptConfig,
    CacheConfig,
    PagedLayout,
    Request,
    RequestClass,
    SchedulingConfig,
    ServeConfig,
    ServeEngine,
    Tenant,
    class_requests,
)
from repro_torch.spec import SpecConfig

from test_torch_common import CACHE_FLIP_SHARE, CACHE_QUANTUM, FACTOR, make_pair
from test_torch_serve import _margin_ok

PAGED = CacheConfig(layout="paged", page_size=4)
VOCAB = 512


@pytest.fixture(scope="module")
def pair():
    return make_pair("native_f32", n_layers=2)


@pytest.fixture(scope="module")
def pair8():
    return make_pair("native_f32", "int8", n_layers=2)


def _requests(n=3, prompt_len=5, max_new=6, shared_prefix=None):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        if shared_prefix is not None:
            prompt = list(shared_prefix) + [i % VOCAB]
        else:
            prompt = rng.integers(0, VOCAB, size=prompt_len).tolist()
        reqs.append(Request(np.asarray(prompt, np.int32), max_new, rid=i))
    return reqs


def _run(model, params, reqs, **cfg_kw):
    eng = ServeEngine(model, params, config=ServeConfig(**cfg_kw))
    return eng.generate_batch([dataclasses.replace(r) for r in reqs]), eng


ARMS = {
    "plain": {},
    "modal": dict(adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=2)),
    "spec": dict(spec=SpecConfig(k=2, draft_shift=1)),
}


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_paged_tokens_equal_dense(pair, pair8, arm, kv):
    """More requests than slots, ragged prompts: the paged engine emits the
    dense engine's tokens through the plain step, the adaptive (modal) step
    with its probe, and the speculative round."""
    _, _, model, params = pair if kv == "bfloat16" else pair8
    reqs = [dataclasses.replace(r, max_new=m) for r, m in
            zip(_requests(n=5, prompt_len=6), (6, 4, 7, 5, 3))]
    dense, _ = _run(model, params, reqs, batch_slots=3, max_len=16, **ARMS[arm])
    paged, eng = _run(model, params, reqs, batch_slots=3, max_len=16, cache=PAGED,
                      **ARMS[arm])
    assert paged == dense
    assert isinstance(eng.layout, PagedLayout)
    assert eng.metrics.summary()["pages"]["pages_total"] == 3 * 4
    assert eng.graph_capture_count == 0 and eng.kernel_build_count == 0
    if arm == "modal":
        assert eng.controller.history
    if arm == "spec":
        assert eng.metrics.spec_rounds > 0


def test_spec_rollback_through_a_ring_wrap_into_shared_pages(pair):
    """Budgets run to the cache's capacity, so the last speculative rounds
    append past it and wrap onto the rows' shared prompt pages: they fork,
    the rollback restores the rejected writes, and the tokens equal the
    dense speculative engine's and the plain engine's."""
    _, _, model, params = pair
    reqs = _requests(n=3, max_new=12, shared_prefix=[7] * 8)  # 9-token prompts
    spec = SpecConfig(k=2, draft_shift=1)
    plain, _ = _run(model, params, reqs, batch_slots=3, max_len=16)
    dense, _ = _run(model, params, reqs, batch_slots=3, max_len=16, spec=spec)
    paged, eng = _run(model, params, reqs, batch_slots=3, max_len=16, spec=spec,
                      cache=PAGED)
    assert paged == dense == plain
    s = eng.metrics.summary()["pages"]
    assert s["shared_hits"] > 0 and s["cow_copies"] > 0


def test_paged_engine_vs_reference_paged_engine(pair):
    """The port's paged engine against the reference's, request by request
    under the margin rule; the host-side page accounting (pool size,
    prefix hits, forks, peak occupancy) is the reference's exactly."""
    jmodel, jparams, model, params = pair
    tol = MODE_REL_ERROR[Mode.M24] * FACTOR + CACHE_QUANTUM["bfloat16"] * CACHE_FLIP_SHARE
    reqs = _requests(n=4, max_new=6, shared_prefix=[5] * 8) + [
        dataclasses.replace(r, rid=10 + r.rid) for r in _requests(n=2, prompt_len=7)]
    jeng = JServeEngine(jmodel, jparams, config=JServeConfig(
        batch_slots=3, max_len=20, cache=JCacheConfig(layout="paged", page_size=4)))
    want = jeng.generate_batch([JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
    got, eng = _run(model, params, reqs, batch_slots=3, max_len=20, cache=PAGED)
    compared = 0
    for r in reqs:
        assert len(got[r.rid]) == len(want[r.rid])
        for i, ok in enumerate(_margin_ok(jmodel, jparams, r.prompt, want[r.rid], tol)):
            if not ok:
                break  # past an undecided token the streams may diverge
            assert got[r.rid][i] == want[r.rid][i], (r.rid, i)
            compared += 1
    assert compared >= 0.8 * sum(len(v) for v in want.values())
    js, ts = jeng.metrics.summary()["pages"], eng.metrics.summary()["pages"]
    for key in ("pages_total", "pages_used", "shared_hits", "cow_copies", "index_evictions",
                "occupancy_peak", "sharing_peak", "page_evictions", "dense_equiv_slots"):
        assert ts[key] == js[key], key
    assert eng.describe_cache() == jeng.describe_cache()


def test_prefix_sharing_gives_identical_tokens_with_fewer_pages(pair):
    _, _, model, params = pair
    reqs = _requests(n=3, max_new=6, shared_prefix=[7] * 8)
    dense, _ = _run(model, params, reqs, batch_slots=3, max_len=20)
    shared, eng = _run(model, params, reqs, batch_slots=3, max_len=20, cache=PAGED)
    private, eng_p = _run(model, params, reqs, batch_slots=3, max_len=20,
                          cache=dataclasses.replace(PAGED, prefix_sharing=False))
    assert shared == dense == private
    s, p = eng.metrics.summary()["pages"], eng_p.metrics.summary()["pages"]
    assert s["shared_hits"] == 2 * 2 and s["sharing_peak"] > 0  # 2 rows x 2 pages
    assert p["shared_hits"] == 0
    assert s["occupancy_peak"] < p["occupancy_peak"]


def test_pool_exhaustion_parks_a_victim_and_never_corrupts(pair):
    """Eight pages of four tokens under four slots: page pressure parks a
    running row (its exact state, gathered as a dense row) and resumes it
    later; every request's tokens equal the dense engine's and its own solo
    run, parked ones included."""
    _, _, model, params = pair
    reqs = _requests(n=6, prompt_len=4, max_new=7)
    dense, _ = _run(model, params, reqs, batch_slots=4, max_len=12)
    small = CacheConfig(layout="paged", page_size=4, pool_pages=8, prefix_sharing=False)
    paged, eng = _run(model, params, reqs, batch_slots=4, max_len=12, cache=small)
    assert paged == dense
    s = eng.metrics.summary()
    assert s["pages"]["page_evictions"] >= 1
    assert s["peak_active"] > s["pages"]["dense_equiv_slots"]
    parked = [rid for rid, r in eng.metrics.requests.items() if r.preemptions]
    assert parked and not eng._parked
    for rid in parked:
        solo, _ = _run(model, params, [reqs[rid]], batch_slots=1, max_len=12)
        assert paged[rid] == solo[rid], rid


def test_tenancy_preemption_parks_paged_rows(pair):
    _, _, model, params = pair
    tenants = [Tenant("chat", priority=0, share=1.0), Tenant("bulk", priority=2, share=1.0)]
    classes = [RequestClass("chat", slo_steps=6, prompt_len=3, max_new=4),
               RequestClass("batch", prompt_len=5, max_new=8)]

    def go(cache):
        rng = np.random.default_rng(0)
        reqs = class_requests(classes[1], tenants[1], 2, VOCAB, rng)
        reqs += class_requests(classes[0], tenants[0], 2, VOCAB, rng, rid_base=100)
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=16, cache=cache,
            scheduling=SchedulingConfig(tenants=tenants, classes=classes, min_quantum=1)))
        for r in reqs[:2]:  # bulk fills both slots first
            eng.submit(r)
        for _ in range(3):
            eng.step()
        for r in reqs[2:]:  # urgent chat arrives and preempts
            eng.submit(r)
        return eng.drain(), eng

    dense, _ = go(CacheConfig())
    paged, eng = go(PAGED)
    assert paged == dense
    assert eng.metrics.summary()["preemptions"] >= 1


# ---------------------------------------------------------------------------
# precision tiers
# ---------------------------------------------------------------------------


def _tiered(budget=None, levels=(5, 3)):
    return CacheConfig(layout="paged", page_size=4, tier_policy=PageTierPolicy(
        levels=levels, cold_after=4, every=2, budget=budget))


def test_open_loop_tiers_demote_like_the_reference(pair):
    """Open loop the tier timeline depends only on page ages: the port
    demotes the same pages at the same ticks as the reference's engine,
    with a measured residual, and the passes write the pools in place."""
    jmodel, jparams, model, params = pair
    reqs = _requests(prompt_len=8, max_new=10)
    eng = ServeEngine(model, params, config=ServeConfig(
        batch_slots=3, max_len=24, cache=_tiered()))
    ptrs = [x.data_ptr() for x in state_leaves(eng.state)]
    out = eng.generate_batch(reqs)
    assert [x.data_ptr() for x in state_leaves(eng.state)] == ptrs
    assert all(len(v) == 10 for v in out.values())
    s = eng.metrics.summary()["pages"]
    assert s["tier_ticks"] >= 1 and s["tier_demoted"] >= 1 and s["tier_err_max"] > 0
    jeng = JServeEngine(jmodel, jparams, config=JServeConfig(
        batch_slots=3, max_len=24, cache=JCacheConfig(
            layout="paged", page_size=4, tier_policy=JPageTierPolicy(
                levels=(5, 3), cold_after=4, every=2))))
    jeng.generate_batch([JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
    got = [(step, t["demoted"], t["depth"], t["keep"]) for step, t in eng.metrics.tier_events]
    want = [(step, t["demoted"], t["depth"], t["keep"]) for step, t in jeng.metrics.tier_events]
    assert got == want
    for (_, t), (_, jt) in zip(eng.metrics.tier_events, jeng.metrics.tier_events):
        assert t["err"] == pytest.approx(jt["err"], rel=0.05)


def test_budgeted_tiers_respect_the_budget(pair):
    _, _, model, params = pair
    budget = 0.05
    _, eng = _run(model, params, _requests(prompt_len=8, max_new=10), batch_slots=3,
                  max_len=24, cache=_tiered(budget=budget, levels=(6, 4)))
    s = eng.metrics.summary()["pages"]
    assert s["tier_ticks"] >= 1 and s["tier_err_max"] <= budget
    assert "budget=0.05" in eng.describe_cache()


def test_tiers_require_a_bf16_cache(pair8):
    _, _, model, params = pair8
    with pytest.raises(ValueError, match="bfloat16"):
        ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=12, cache=_tiered()))
    with pytest.raises(ValueError, match="requires layout='paged'"):
        CacheConfig(tier_policy=PageTierPolicy(levels=(5,)))


def test_from_flags_builds_a_paged_tiered_cache():
    ns = argparse.Namespace(
        slots=0, requests=4, prompt_len=6, max_new=8, accuracy=None,
        tune_table="", scheduler_policy="priority", adapt=False,
        adapt_every=4, speculate=False, paged=True, page_size=8,
        pool_pages=32, no_prefix_sharing=False, tier_levels="5,3",
        tier_cold_after=16, tier_every=4, tier_budget=0.1)
    c = ServeConfig.from_flags(ns)
    assert c.batch_slots == 4 and c.cache.layout == "paged"
    assert c.cache.page_size == 8 and c.cache.pool_pages == 32
    assert c.cache.tier_policy == PageTierPolicy(levels=(5, 3), cold_after=16, every=4,
                                                 budget=0.1)


@pytest.mark.parametrize("flags", [
    ["--paged"],
    ["--speculate", "--paged", "--draft-k", "2"],
    ["--paged", "--page-size", "4", "--tier-levels", "5,3", "--tier-cold-after", "4",
     "--tier-every", "2"],
])
def test_launcher_paged_flags_serve_on_the_cpu(capsys, flags):
    launch_serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "6",
                       "--prompt-len", "10", *flags])
    out = capsys.readouterr().out
    assert "req 2:" in out and "paged cache: 2 slots" in out and "| pages " in out


# ---------------------------------------------------------------------------
# in-place pools: the invariants
# ---------------------------------------------------------------------------


def _held(eng):
    """(page, prefix key) of every page no row may write: shared by rows or
    held by the prefix index."""
    pool = eng.layout.groups[0].pool
    return {(p, pool.page_key.get(p)) for p in range(1, pool.n_pages + 1)
            if pool.ref[p] > 1 or p in pool.page_key}


def _pages(eng, held):
    nodes = eng.state.caches["seg0_dense"]
    return {h: [(n.k_pool[h[0]].clone(), n.v_pool[h[0]].clone()) for n in nodes]
            for h in held}


@pytest.mark.parametrize("arm", ["plain", "spec"])
def test_shared_pages_never_change_and_tensors_never_rebind(pair, arm):
    """Step by step through shared prefixes, ring wraps (budgets to the
    capacity) and speculative rounds: a page that is shared or index-held
    before and after a step keeps its bits (the forks took the writes), and
    every tensor of the state keeps its address (nothing cloned or
    rebound).  Tier passes, which do rewrite cold shared pages, are held in
    ``test_open_loop_tiers_demote_like_the_reference``."""
    _, _, model, params = pair
    eng = ServeEngine(model, params, config=ServeConfig(
        batch_slots=3, max_len=16, cache=PAGED, **ARMS[arm]))
    ptrs = [x.data_ptr() for x in state_leaves(eng.state)]
    for r in _requests(n=4, max_new=12, shared_prefix=[7] * 8):
        eng.submit(r)
    checked = 0
    while eng.scheduler.has_work():
        before = _held(eng)
        pages = _pages(eng, before)
        eng.step()
        for h in before & _held(eng):
            for (k0, v0), n in zip(pages[h], eng.state.caches["seg0_dense"]):
                assert torch.equal(n.k_pool[h[0]], k0) and torch.equal(n.v_pool[h[0]], v0)
                checked += 1
    assert checked > 0
    s = eng.metrics.summary()["pages"]
    assert s["shared_hits"] > 0
    # budgets are clamped to the capacity, so only a round's k+1 appends wrap
    assert (s["cow_copies"] > 0) == (arm == "spec")
    assert [x.data_ptr() for x in state_leaves(eng.state)] == ptrs


@pytest.mark.parametrize("arm", ["plain", "spec"])
def test_paged_rows_equal_dense_rows_after_every_step(pair, arm):
    """A paged and a dense engine in lockstep over shared prefixes and
    budgets that run to the capacity: after every step each active row's
    content equals the dense row's at every valid slot — after a
    speculative round's rollback too, whose rejected appends may have
    wrapped onto live slots of the row."""
    _, _, model, params = pair
    engines = [ServeEngine(model, params, config=ServeConfig(
        batch_slots=3, max_len=16, cache=cache, **ARMS[arm])) for cache in (PAGED, CacheConfig())]
    for eng in engines:
        for r in _requests(n=4, max_new=12, shared_prefix=[7] * 8):
            eng.submit(r)
    compared = 0
    while engines[1].scheduler.has_work():
        assert engines[0].step() == engines[1].step()
        for slot in np.nonzero(engines[1]._active)[0]:
            rows = [eng.layout.gather_row(eng.state, int(slot)) for eng in engines]
            for p, d in zip(rows[0].caches["seg0_dense"], rows[1].caches["seg0_dense"]):
                assert torch.equal(p.pos, d.pos) and torch.equal(p.length, d.length)
                valid = d.pos[0] >= 0
                assert torch.equal(p.k[0][valid], d.k[0][valid]), slot
                assert torch.equal(p.v[0][valid], d.v[0][valid]), slot
                compared += 1
    assert compared > 0


def test_probe_leaves_every_pool_bitwise_intact(pair):
    """The adaptive engine's probe reads the paged state without writing:
    every leaf, every pool included, is bit-identical after three probe
    steps and a controller tick (the engine probes nothing by itself here,
    so the slots a probe would append to hold no probe's write)."""
    _, _, model, params = pair
    eng = ServeEngine(model, params, config=ServeConfig(
        batch_slots=3, max_len=20, cache=PAGED,
        adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=100, adapt=False)))
    for r in _requests(n=3, max_new=12, shared_prefix=[3] * 8):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    before = [x.clone() for x in state_leaves(eng.state)]
    table = eng.mode_table
    errs = eng._probe_fn(table.scalars(), table.scalars_shifted(2), table.scalars_shifted(-1))
    eng._adapt_tick()
    assert all(torch.equal(x, y) for x, y in zip(state_leaves(eng.state), before))
    assert errs[0] == 0.0 and errs[1] > 0.0  # M24 is the reference; one down is not


def test_probe_residuals_equal_the_dense_probe_at_every_step(pair):
    """A paged and a dense adaptive engine in lockstep, rows of one length:
    after every step the probe's two residuals are equal.  Every few steps
    all rows' next slot lies on a page not mapped yet, which the table
    sends to the one scratch page; a probe that wrote its fresh K/V there
    would hand each row another row's K/V, so the probe places them in its
    gathered view instead."""
    _, _, model, params = pair
    adapt = AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1000, adapt=False)
    engines = [ServeEngine(model, params, config=ServeConfig(
        batch_slots=3, max_len=24, cache=cache, adapt=adapt)) for cache in (PAGED, CacheConfig())]
    for eng in engines:
        for r in _requests(n=3, max_new=12, shared_prefix=[3] * 7):
            eng.submit(r)
    unmapped = 0
    while engines[1].scheduler.has_work():
        assert engines[0].step() == engines[1].step()
        if not engines[1]._active.any():
            continue
        tbl = engines[0].state.caches["seg0_dense"][0].page_tbl
        nxt = torch.from_numpy(engines[0]._row_len.astype(np.int64)) % 24 // 4
        unmapped += int((tbl.gather(1, nxt[:, None].long())[:, 0] < 0)[
            torch.from_numpy(engines[0]._active)].sum())
        t = engines[1].mode_table
        args = (t.scalars(), t.scalars_shifted(2), t.scalars_shifted(-1))
        assert engines[0]._probe_fn(*args) == engines[1]._probe_fn(*args)
    assert unmapped >= 3


def test_steps_merge_and_copy_back_only_the_row_leaves(pair):
    """What a step's merge and copy-back write (``batch_leaves``) is the
    per-row leaves; the shared pools and page tables are left out.  The
    compiled steps' snapshot, which undoes a capture's warm-up, puts back
    those leaves and the pool slots the step appends to, bit for bit."""
    from repro_torch.serve.paged import batch_leaves

    _, _, model, params = pair
    eng = ServeEngine(model, params, config=ServeConfig(
        batch_slots=2, max_len=16, cache=PAGED, **ARMS["spec"]))
    node = eng.state.caches["seg0_dense"][0]
    written = {id(x) for x in batch_leaves(eng._axes, eng.state)}
    assert id(node.pos) in written and id(node.length) in written
    assert not written & {id(node.k_pool), id(node.v_pool), id(node.page_tbl)}
    dense = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=16))
    assert len(batch_leaves(dense._axes, dense.state)) == len(state_leaves(dense.state))
    for r in _requests(n=2, max_new=8, shared_prefix=[7] * 8):
        eng.submit(r)
    eng.step()
    eng._prepare_pages()
    before = [x.clone() for x in state_leaves(eng.state)]
    restore = eng._round_graph.snapshot()
    eng._device_inputs()
    eng._round_graph()  # on the CPU: the round, eagerly, on the static state
    assert not all(torch.equal(x, y) for x, y in zip(state_leaves(eng.state), before))
    restore()
    assert all(torch.equal(x, y) for x, y in zip(state_leaves(eng.state), before))