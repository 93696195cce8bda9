"""Port vs reference, the multi-tenant engine paths: per-tenant adaptation
(one mode table and controller per tenant, the modal step bound to the
per-site maximum over the tenants with active slots, each tenant's probe
masked to its own slots), the dense family's differential exactness under
preemption, and ServeMetrics' per-tenant edge cases — on the CPU at the
smoke size."""
import dataclasses

import numpy as np
import pytest
import jax

from scheduler_model import check_slot_accounting
from repro.adapt import SLO as JSLO
from repro.adapt.workload import conditioned_model as j_conditioned_model
from repro.core.precision import Mode as JMode
from repro.serve import ServeEngine as JServeEngine
from repro.serve.tenancy import Tenant as JTenant

from repro_torch.adapt import SLO, HysteresisController
from repro_torch.adapt.workload import ConditionedWorkload, conditioned_config, conditioned_model
from repro_torch.convert import params_from_jax
from repro_torch.core.precision import Mode
from repro_torch.models import build_model
from repro_torch.serve import (
    AdaptConfig,
    CacheConfig,
    Request,
    RequestClass,
    SchedulingConfig,
    ServeConfig,
    ServeEngine,
    ServeMetrics,
    Tenant,
    class_requests,
)
from repro_torch.serve.tenancy import normalize_classes, normalize_tenants
from repro_torch.spec import SpecConfig

from test_torch_common import make_pair

TENANTS = [
    Tenant("interactive", priority=0, share=2.0),
    Tenant("bulk", priority=2, share=1.0),
]
CLASSES = [
    RequestClass("chat", slo_steps=8, prompt_len=6, max_new=5),
    RequestClass("batch", prompt_len=8, max_new=12),
]
HOT_COLD = [Tenant("hot", priority=1), Tenant("cold", priority=1)]


@pytest.fixture(scope="module")
def tiny():
    """(port model, port params) at two layers under native_f32, the
    reference tests' tiny model with numpy-made weights."""
    _, _, model, params = make_pair("native_f32", n_layers=2)
    return model, params


def _engine(model, params, *, slots=2, max_len=32, **kw):
    sched = {k: kw.pop(k) for k in ("tenants", "classes", "policy", "preempt",
                                    "aging_steps", "min_quantum") if k in kw}
    return ServeEngine(model, params, config=ServeConfig(
        batch_slots=slots, max_len=max_len, scheduling=SchedulingConfig(**sched), **kw))


def _mixed_requests(vocab, rng):
    """3 bulk/batch + 2 interactive/chat — bulk submitted first so it
    saturates the slots before the urgent traffic arrives."""
    bulk = class_requests(CLASSES[1], TENANTS[1], 3, vocab, rng, rid_base=0)
    chat = class_requests(CLASSES[0], TENANTS[0], 2, vocab, rng, rid_base=10)
    return bulk, chat


def _contended_drain(eng, bulk, chat, warmup=3):
    for r in bulk:
        eng.submit(r)
    for _ in range(warmup):
        eng.step()
    for r in chat:
        eng.submit(r)
    out = eng.drain()
    check_slot_accounting(eng.scheduler)
    return out


def _solo_outputs(model, params, reqs, max_len=32):
    """Each request served alone at batch_slots=1 (one engine reused; rids
    offset to keep them unique)."""
    eng = _engine(model, params, slots=1, max_len=max_len)
    out = {}
    for r in reqs:
        clone = Request(prompt=r.prompt, max_new=r.max_new, rid=r.rid + 1000)
        out[r.rid] = eng.generate_batch([clone])[clone.rid]
    return out


# ---------------------------------------------------------------------------
# differential exactness under preemption (dense family)
# ---------------------------------------------------------------------------


class TestDifferentialExactness:
    def test_dense_exact_under_preemption(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(2)
        bulk, chat = _mixed_requests(model.cfg.vocab, rng)
        eng = _engine(model, params, tenants=TENANTS, classes=CLASSES,
                      aging_steps=4, min_quantum=1)
        out = _contended_drain(eng, bulk, chat)
        assert eng.scheduler.preemptions >= 1
        solo = _solo_outputs(model, params, bulk + chat)
        for r in bulk + chat:
            assert out[r.rid] == solo[r.rid], r.rid

    def test_exact_with_speculation(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(3)
        bulk, chat = _mixed_requests(model.cfg.vocab, rng)
        eng = _engine(model, params, tenants=TENANTS, classes=CLASSES,
                      aging_steps=4, min_quantum=1, spec=SpecConfig(k=2, draft_shift=1))
        out = _contended_drain(eng, bulk, chat)
        assert eng.scheduler.preemptions >= 1
        solo = _solo_outputs(model, params, bulk + chat)
        for r in bulk + chat:
            assert out[r.rid] == solo[r.rid], r.rid

    def test_fifo_policy_also_exact(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(4)
        bulk, chat = _mixed_requests(model.cfg.vocab, rng)
        eng = _engine(model, params, tenants=TENANTS, classes=CLASSES, policy="fifo")
        out = _contended_drain(eng, bulk, chat)
        assert eng.scheduler.preemptions == 0
        solo = _solo_outputs(model, params, bulk + chat)
        for r in bulk + chat:
            assert out[r.rid] == solo[r.rid], r.rid

    def test_forced_preemption_roundtrip_exact(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(5)
        long = Request(prompt=rng.integers(0, model.cfg.vocab, 6).astype(np.int32),
                       max_new=10, rid=0, tenant="bulk", rclass="batch")
        urgent = Request(prompt=rng.integers(0, model.cfg.vocab, 4).astype(np.int32),
                         max_new=3, rid=1, tenant="interactive", rclass="chat")
        eng = _engine(model, params, slots=1, tenants=TENANTS, classes=CLASSES, min_quantum=1)
        eng.submit(long)
        for _ in range(3):
            eng.step()
        eng.submit(urgent)
        out = eng.drain()
        assert eng.scheduler.tickets[0].preemptions >= 1
        solo = _solo_outputs(model, params, [long, urgent])
        assert out[0] == solo[0] and out[1] == solo[1]

    def test_exact_under_preemption_with_per_tenant_adaptation(self):
        """Parking and resuming rows under per-tenant tables: each request's
        tokens equal its solo decode on a modal engine whose tables hold
        (monitor mode, M24 = the reference mode, so every probe reads 0)."""
        _, _, model, params = make_pair("M24", n_layers=2)
        rng = np.random.default_rng(2)
        bulk, chat = _mixed_requests(model.cfg.vocab, rng)
        adapt = AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1, adapt=False)
        eng = _engine(model, params, tenants=TENANTS, classes=CLASSES,
                      aging_steps=4, min_quantum=1, adapt=adapt)
        out = _contended_drain(eng, bulk, chat)
        assert eng.scheduler.preemptions >= 1
        solo = _solo_outputs(model, params, bulk + chat)
        for r in bulk + chat:
            assert out[r.rid] == solo[r.rid], r.rid
        assert sum(len(c.history) for c in eng.tenant_ctrl.values()) > 0


# ---------------------------------------------------------------------------
# per-tenant adaptation
# ---------------------------------------------------------------------------


def _set_table(table, modes: dict):
    for site, m in modes.items():
        table.set(site, int(m))


#: (modes per tenant as a rung per site offset, active counts)
BOUND_CASES = {
    "one_active": ({"hot": 2, "cold": 0, "default": 0}, {"cold": 1}),
    "two_active_max": ({"hot": 1, "cold": 0, "default": 2}, {"hot": 2, "cold": 1}),
    "none_active_binds_all": ({"hot": 1, "cold": 0, "default": 2}, {}),
    "staggered": ({"hot": 0, "cold": 1, "default": 0}, {"hot": 1, "cold": 1}),
}


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_bound_scalars_equal_the_reference(case):
    rungs, active = BOUND_CASES[case]
    jwl = j_conditioned_model()
    jeng = JServeEngine(jwl.model, jwl.params, batch_slots=2, max_len=32,
                        slo=JSLO(max_err=0.5),
                        tenants=[JTenant("hot", priority=1), JTenant("cold", priority=1)])
    wl = conditioned_model(device="cpu")
    eng = _engine(wl.model, wl.params, tenants=HOT_COLD, adapt=AdaptConfig(slo=SLO(max_err=0.5)))
    assert set(eng.tenant_tables) == set(jeng.tenant_tables) == {"hot", "cold", "default"}
    sites = sorted(eng.tenant_tables["hot"].modes())
    assert sites == sorted(jeng.tenant_tables["hot"].modes())
    for name, rung in rungs.items():
        # a staggered table: every other site one rung above the tenant's
        modes = {s: min(int(Mode.M8) + rung + (i % 2 if case == "staggered" else 0),
                        int(Mode.M24)) for i, s in enumerate(sites)}
        _set_table(eng.tenant_tables[name], modes)
        _set_table(jeng.tenant_tables[name], {s: JMode(m) for s, m in modes.items()})
    got, label = eng._bound_scalars(active)
    want, jlabel = jeng._bound_scalars(active)
    assert got == {s: int(v) for s, v in want.items()}
    assert label == jlabel
    assert all(isinstance(v, int) for v in got.values())


def _hot_cold_engine(wl, **kw):
    return _engine(wl.model, wl.params, slots=4, max_len=48, tenants=HOT_COLD,
                   adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1), **kw)


def _hot_cold_requests(wl, request_cls=Request):
    rng = np.random.default_rng(0)
    hot = wl.requests(4, hot={0, 1, 2, 3}, rng=rng, max_new=12)
    cold = wl.requests(4, hot=set(), rng=rng, max_new=12)
    return ([request_cls(r.prompt, r.max_new, rid=r.rid, tenant="hot") for r in hot]
            + [request_cls(r.prompt, r.max_new, rid=r.rid + 100, tenant="cold") for r in cold])


class TestPerTenantAdaptIsolation:
    def test_hot_tenant_shifts_cold_tenant_holds(self):
        wl = conditioned_model(device="cpu")
        eng = _hot_cold_engine(wl)
        assert eng.mode_table is None and eng.controller is None
        for r in _hot_cold_requests(wl):
            eng.submit(r)
        # which tenants had active slots at each tick
        ticked = {"hot": 0, "cold": 0, "default": 0}
        tick = eng._adapt_tick_tenants

        def counted_tick():
            for name in eng._tenant_active():
                ticked[name] += 1
            tick()

        eng._adapt_tick_tenants = counted_tick
        captures, builds, written = set(), set(), []
        while eng.scheduler.has_work():
            eng.step()
            captures.add(eng.graph_capture_count)
            builds.add(eng.kernel_build_count)
            written.append(eng._step_modes._written)
        assert eng.tenant_ctrl["hot"].up_shifts >= 1
        assert int(Mode[eng.tenant_tables["hot"].label()]) > int(Mode.M8)
        # isolation: the cold tenant's controller never saw the hot residuals
        assert eng.tenant_ctrl["cold"].up_shifts == 0
        assert eng.tenant_tables["cold"].label() == "M8"
        assert eng.tenant_tables["default"].switches == 0
        # one step serves every combination of tables: nothing captured or built
        assert captures == {0} and builds == {0}
        assert eng.decode_compile_count == 0
        # the bound view moved to the hot tenant's modes while it decoded
        assert len({w for w in written if w is not None}) >= 2
        # one probe per tenant per tick with active slots, and no other
        assert {n: len(c.history) for n, c in eng.tenant_ctrl.items()} == ticked
        assert ticked["hot"] > 0 and ticked["cold"] > 0 and ticked["default"] == 0
        assert "per-tenant" in eng.describe_adaptation()
        for name in ("hot", "cold", "default"):
            assert f"tenant {name}: table" in eng.describe_adaptation()

    def test_against_the_reference_on_its_params(self):
        """Both engines on the reference's doctored parameters and the same
        hot/cold traffic: the same controller decisions per tenant, the
        same tokens, the same bound-mode labels."""
        jwl = j_conditioned_model()
        jeng = JServeEngine(jwl.model, jwl.params, batch_slots=4, max_len=48,
                            slo=JSLO(max_err=0.5), adapt_every=1,
                            tenants=[JTenant("hot", priority=1), JTenant("cold", priority=1)])
        from repro.serve.scheduler import Request as JRequest

        for r in _hot_cold_requests(jwl, JRequest):
            jeng.submit(r)
        want = jeng.drain()
        cfg = conditioned_config()
        wl = ConditionedWorkload(
            cfg=cfg, model=build_model(cfg, device="cpu"),
            params=params_from_jax(jax.tree.map(np.asarray, jwl.params), device="cpu"),
            hot_ids=jwl.hot_ids, safe_vocab=jwl.safe_vocab)
        eng = _hot_cold_engine(wl)
        for r in _hot_cold_requests(wl):
            eng.submit(r)
        got = eng.drain()
        assert got == want
        for name in ("hot", "cold"):
            g = [(o.step, o.decision) for o in eng.tenant_ctrl[name].history]
            w = [(o.step, o.decision) for o in jeng.tenant_ctrl[name].history]
            assert g == w, name
            assert eng.tenant_tables[name].label() == jeng.tenant_tables[name].label()
        assert eng.metrics.mode_timeline == jeng.metrics.mode_timeline
        assert eng.metrics.summary()["mode_occupancy"] == jeng.metrics.summary()["mode_occupancy"]

    def test_tenant_mask_never_reaches_the_decode_step(self):
        wl = conditioned_model(device="cpu")
        eng = _hot_cold_engine(wl)
        for r in _hot_cold_requests(wl)[:2] + _hot_cold_requests(wl)[4:6]:
            eng.submit(r)
        masks = []
        real = eng._probe_fn

        def probe(cur, ref, down, mask=None):
            masks.append(mask.clone())
            return real(cur, ref, down, mask)

        eng._probe_fn = probe
        for _ in range(3):
            eng.step()
            # the decode step's active rows are the host mirror, whatever
            # mask the last tenant's probe used
            assert eng._active_dev.tolist() == eng._active.tolist()
        by_slot = {s: t.tenant for s, t in eng.scheduler.by_slot.items()}
        assert masks and all(m.sum() >= 1 for m in masks)
        for m in masks:  # every mask holds one tenant's slots only
            assert len({by_slot[i] for i in np.nonzero(m.numpy())[0]}) == 1

    def test_monitor_mode_probes_but_never_shifts(self):
        wl = conditioned_model(device="cpu")
        eng = _engine(wl.model, wl.params, slots=4, max_len=48, tenants=HOT_COLD,
                      adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1, adapt=False))
        for r in _hot_cold_requests(wl):
            eng.submit(r)
        eng.drain()
        assert all(t.switches == 0 for t in eng.tenant_tables.values())
        assert max(o.err for o in eng.tenant_ctrl["hot"].history) > 0.5
        assert max(o.err for o in eng.tenant_ctrl["cold"].history) < 0.5

    def test_tenant_accuracy_overrides_the_slo(self, tiny):
        model, params = tiny
        tenants = [Tenant("tight", accuracy=1e-3), Tenant("loose")]
        eng = _engine(model, params, tenants=tenants,
                      adapt=AdaptConfig(slo=SLO(max_err=0.25, target_ms=5.0, down_factor=0.5)))
        assert eng.tenant_ctrl["tight"].slo == SLO(max_err=1e-3, target_ms=5.0, down_factor=0.5)
        assert eng.tenant_ctrl["loose"].slo == SLO(max_err=0.25, target_ms=5.0, down_factor=0.5)
        assert eng.tenant_ctrl["tight"].name == "adapt/tight"
        assert all(c.tracer is eng.tracer for c in eng.tenant_ctrl.values())
        assert eng.tenant_tables["tight"] is not eng.tenant_tables["loose"]

    def test_paged_layout_gives_the_dense_tokens(self):
        wl = conditioned_model(device="cpu")
        runs = {}
        for layout in ("dense", "paged"):
            eng = _hot_cold_engine(wl, cache=CacheConfig(layout=layout, page_size=4))
            for r in _hot_cold_requests(wl):
                eng.submit(r)
            runs[layout] = (eng.drain(), eng)
        (dense, d_eng), (paged, p_eng) = runs["dense"], runs["paged"]
        assert paged == dense
        assert p_eng.layout.name == "paged"
        for name in ("hot", "cold"):
            assert [o.decision for o in p_eng.tenant_ctrl[name].history] == \
                [o.decision for o in d_eng.tenant_ctrl[name].history]
        assert p_eng.metrics.mode_timeline == d_eng.metrics.mode_timeline

    def test_speculate_with_per_tenant_adapt_refused(self, tiny):
        model, params = tiny
        with pytest.raises(NotImplementedError, match="per-tenant"):
            _engine(model, params, tenants=[Tenant("a")],
                    adapt=AdaptConfig(slo=SLO(max_err=0.5)),
                    spec=SpecConfig(k=2, draft_shift=1))

    def test_shared_controller_with_tenants_refused(self, tiny):
        model, params = tiny
        with pytest.raises(ValueError, match="per-tenant"):
            _engine(model, params, tenants=[Tenant("a")],
                    adapt=AdaptConfig(slo=SLO(max_err=0.5),
                                      controller=HysteresisController(SLO(max_err=0.5))))


# ---------------------------------------------------------------------------
# ServeMetrics per-tenant accounting corners
# ---------------------------------------------------------------------------


class TestMetricsEdgeCases:
    def test_zero_completed_tenant(self):
        m = ServeMetrics(slots=2)
        m.set_tenant_shares({"a": 2.0, "b": 1.0, "idle": 1.0})
        m.on_submit(0, tenant="a", rclass="chat", slo_steps=4, step=0)
        m.on_first_token(0)
        m.on_token(0)
        m.on_decode_step(1, tenant_active={"a": 1})
        m.on_submit(1, tenant="b", rclass="chat", slo_steps=4, step=0)
        ts = m.tenant_summary()
        assert ts["b"]["completed"] == 0
        assert ts["b"]["latency_p50_s"] is None
        assert ts["b"]["latency_p99_s"] is None
        assert ts["b"]["attainment"] == 0.0
        assert ts["idle"]["submitted"] == 0
        assert ts["idle"]["attainment"] is None
        assert ts["idle"]["entitlement"] == 0.0
        assert ts["a"]["entitlement"] == pytest.approx(2 / 3)
        assert ts["a"]["slot_share"] == 1.0

    def test_preempted_ttft_is_recorded_once(self):
        t = [0.0]

        def clock():
            t[0] += 1.0
            return t[0]

        m = ServeMetrics(slots=1, clock=clock)
        m.on_submit(0, tenant="a", step=0)
        m.on_first_token(0)
        first = m.ttft(0)
        m.on_preempt(0)
        m.on_first_token(0)
        assert m.ttft(0) == first
        assert m.prefills == 1
        assert m.requests[0].preemptions == 1
        m.on_done(0, step=7)
        assert m.latency(0) is not None

    def test_engine_metrics_agree_with_scheduler_under_preemption(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(6)
        bulk, chat = _mixed_requests(model.cfg.vocab, rng)
        eng = _engine(model, params, tenants=TENANTS, classes=CLASSES,
                      aging_steps=4, min_quantum=1)
        out = _contended_drain(eng, bulk, chat)
        assert eng.scheduler.preemptions >= 1
        s = eng.metrics.summary()
        assert s["completed"] == len(eng.scheduler.completed) == len(out)
        assert s["preemptions"] == eng.scheduler.preemptions
        assert s["tokens_out"] == sum(len(v) for v in out.values())
        ts = s["tenants"]
        assert ts["bulk"]["preemptions"] == eng.scheduler.preemptions
        assert ts["interactive"]["preemptions"] == 0
        assert eng.metrics.prefills == len(out)
        assert sum(v["slot_share"] for v in ts.values()) == pytest.approx(1.0)
        assert ts["interactive"]["attainment"] is not None
        assert ts["bulk"]["attainment"] is None
        assert "interactive" in eng.describe_tenancy()

    def test_tenant_registry_validation(self, tiny):
        model, params = tiny
        eng = _engine(model, params, slots=1, tenants=TENANTS, classes=CLASSES)
        prompt = np.random.default_rng(0).integers(0, model.cfg.vocab, 4).astype(np.int32)
        with pytest.raises(ValueError, match="unknown tenant"):
            eng.submit(Request(prompt=prompt, rid=0, tenant="nope"))
        with pytest.raises(ValueError, match="unknown request class"):
            eng.submit(Request(prompt=prompt, rid=0, tenant="bulk", rclass="nope"))

    def test_normalize_helpers_and_validation(self):
        reg = normalize_tenants(TENANTS)
        assert set(reg) == {"interactive", "bulk", "default"}
        assert normalize_classes(None) == {"default": RequestClass("default")}
        with pytest.raises(ValueError, match="share"):
            Tenant("x", share=0)
        with pytest.raises(ValueError, match="slo_steps"):
            RequestClass("x", slo_steps=0)
        with pytest.raises(TypeError):
            normalize_tenants([RequestClass("x")])


def test_per_tenant_describe_equals_the_reference_format(tiny):
    """The per-tenant report line for line against the reference's, on
    tables moved the same way."""
    jwl = j_conditioned_model()
    jeng = JServeEngine(jwl.model, jwl.params, batch_slots=2, max_len=32,
                        slo=JSLO(max_err=0.5), tenants=[JTenant("a"), JTenant("b")])
    wl = conditioned_model(device="cpu")
    eng = _engine(wl.model, wl.params, tenants=[Tenant("a"), Tenant("b")],
                  adapt=AdaptConfig(slo=SLO(max_err=0.5)))
    eng.tenant_tables["a"].shift_all(1, tag=3)
    jeng.tenant_tables["a"].shift_all(1, tag=3)
    assert eng.describe_adaptation() == jeng.describe_adaptation()
    assert dataclasses.asdict(eng.tenant_ctrl["b"].slo) == dataclasses.asdict(jeng.tenant_ctrl["b"].slo)
