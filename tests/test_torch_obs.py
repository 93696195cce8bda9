"""Port vs reference, observability (repro_torch.obs): the tracer ring, the
exporters (Chrome trace, Prometheus text), the precision timeline and the
phase profiler give the reference's output on the same event lists with
fixed timestamps; and the engine's tracing contracts on the CPU — traced
tokens equal untraced ones, exported traces are schema-valid, and plain,
multi-tenant, speculative, paged and adaptive runs replay clean through
the scheduler-model invariant harness (tests/scheduler_model.py)."""
import dataclasses
import json

import numpy as np
import pytest

from repro.obs import Event as JEvent
from repro.obs import PhaseProfiler as JPhaseProfiler
from repro.obs import Tracer as JTracer
from repro.obs import format_timeline as j_format_timeline
from repro.obs import precision_timeline as j_precision_timeline
from repro.obs import span_violations as j_span_violations
from repro.obs import to_chrome as j_to_chrome
from repro.obs import to_prometheus as j_to_prometheus
from repro.obs import validate_chrome as j_validate_chrome

from repro_torch.adapt import SLO
from repro_torch.obs import (
    NULL_TRACER,
    Event,
    PhaseProfiler,
    TraceConfig,
    Tracer,
    format_timeline,
    precision_timeline,
    span_violations,
    to_chrome,
    to_prometheus,
    validate_chrome,
)
from repro_torch.serve import (
    AdaptConfig,
    CacheConfig,
    Request,
    RequestClass,
    SchedulingConfig,
    ServeConfig,
    ServeEngine,
    Tenant,
)
from repro_torch.spec import SpecConfig

from scheduler_model import FINISH, SUBMIT, check_replay
from test_torch_common import make_pair

# ---------------------------------------------------------------------------
# event lists handed to both packages: (ts, step, kind, rid, slot, cause, data)
# ---------------------------------------------------------------------------

LIFECYCLE = [
    (0.0, 0, "submit", 0, None, None, {"tenant": "a", "prompt_len": 5}),
    (1.0, 1, "admit", 0, 0, None, None),
    (1.5, 1, "prefill", 0, 0, None, {"dur_ms": 0.4, "prompt_len": 5}),
    (2.0, 1, "token", 0, 0, None, None),
    (2.5, 1, "decode_step", None, None, None, {"dur_ms": 0.3, "n_active": 1, "mode": "M16"}),
    (3.0, 2, "preempt", 0, 0, "priority", None),
    (3.5, 2, "preempt_plan", 0, 0, "priority", {"waiter": 1}),
    (4.0, 3, "resume", 0, 1, None, {"cache_len": 6}),
    (5.0, 3, "token", 0, 1, None, None),
    (6.0, 3, "done", 0, 1, "budget", None),
]
DECISIONS = [
    (0.0, 1, "decode_step", None, None, None, {"dur_ms": 1.0, "n_active": 2, "mode": "M16"}),
    (0.5, 2, "adapt_decision", None, None, "err_violation",
     {"controller": "adapt/hot", "decision": 1, "err": 0.7, "err_down": 0.9}),
    (1.0, 4, "mode_switch", None, None, "err_violation",
     {"direction": 1, "tenant": "hot", "mode": "M24", "sites": {"mlp_up": "M24", "qkv": "M24"}}),
    (2.0, 6, "draft_shift", None, None, "clean_streak", {"shift": 1, "reject_rate": 0.1}),
    (3.0, 8, "tier_tick", None, None, "open_loop", {"keep": 5, "depth": 1, "demoted": 2}),
    (4.0, 8, "mode_switch", None, None, "clean_streak", {"mode": "M16"}),
    (5.0, 9, "spec_round", None, None, None, {"k": 2, "n_active": 2, "drafted": 4}),
    (6.0, 9, "recompile", None, None, "decode_step", {"sizes": {"before": 1, "after": 2}}),
    (7.0, 10, "cow_fork", 3, 1, "shared_page_write", {"pages": 1}),
    (8.0, 10, "page_evict", 3, None, "page_pressure", None),
]
INFLIGHT = LIFECYCLE[:2] + [(9.0, 4, "submit", 7, None, None, None)]
ZERO_BUDGET = [(0.0, 0, "submit", 5, None, None, None), (0.1, 1, "done", 5, -1, "zero_budget", None)]
BAD_ORDER = [(0.0, 0, "admit", 1, 0, None, None), (1.0, 1, "resume", 1, 0, None, None),
             (2.0, 2, "done", 1, 0, "budget", None), (3.0, 3, "token", 1, 0, None, None),
             (4.0, 3, "done", 1, 0, "budget", None)]
EVENT_LISTS = {"lifecycle": LIFECYCLE, "decisions": DECISIONS, "inflight": INFLIGHT,
               "zero_budget": ZERO_BUDGET, "bad_order": BAD_ORDER, "empty": []}
COUNTERS = {"tokens_out": 5, "a.b": 1, "recompiles": 0, "decode_wall_ms": 1.25}
GAUGES = {"active_slots": 2.0, "occ-x": 0.5}


def _events(spec, cls):
    return [cls(ts, step, kind, rid=rid, slot=slot, cause=cause, data=data)
            for ts, step, kind, rid, slot, cause, data in spec]


@pytest.mark.parametrize("name", sorted(EVENT_LISTS))
def test_chrome_equals_the_reference(name):
    spec = EVENT_LISTS[name]
    got = to_chrome(_events(spec, Event), COUNTERS, GAUGES)
    want = j_to_chrome(_events(spec, JEvent), COUNTERS, GAUGES)
    assert got == want
    assert validate_chrome(got) == j_validate_chrome(want)
    json.dumps(got)


@pytest.mark.parametrize("name", sorted(EVENT_LISTS))
def test_span_violations_equal_the_reference(name):
    spec = EVENT_LISTS[name]
    got = span_violations(_events(spec, Event))
    assert got == j_span_violations(_events(spec, JEvent))
    assert bool(got) == (name == "bad_order")


@pytest.mark.parametrize("name", sorted(EVENT_LISTS))
def test_timeline_equals_the_reference(name):
    spec = EVENT_LISTS[name]
    got = precision_timeline(_events(spec, Event))
    assert got == j_precision_timeline(_events(spec, JEvent))
    assert format_timeline(got) == j_format_timeline(got)


@pytest.mark.parametrize("counters,gauges", [(COUNTERS, GAUGES), ({}, {}), ({"x y": 2.5e-9}, {})])
def test_prometheus_equals_the_reference(counters, gauges):
    assert to_prometheus(counters, gauges) == j_to_prometheus(counters, gauges)


MALFORMED = {
    "no_events": {},
    "not_a_list": {"traceEvents": {"ph": "X"}},
    "not_an_object": {"traceEvents": [3]},
    "missing_keys": {"traceEvents": [{"ph": "i", "pid": 1}]},
    "unknown_ph": {"traceEvents": [{"ph": "B", "pid": 1, "tid": 0, "name": "a", "ts": 0}]},
    "no_ts": {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0, "name": "a", "dur": 1}]},
    "bad_dur": {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0, "dur": -1}]},
    "bad_scope": {"traceEvents": [{"ph": "i", "pid": 1, "tid": 0, "name": "a", "ts": 0, "s": "x"}]},
    "overlap": {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "pid": 1, "tid": 0, "name": "b", "ts": 5, "dur": 10}]},
    "nested_ok": {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "pid": 1, "tid": 0, "name": "b", "ts": 2, "dur": 3}]},
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_validate_chrome_catches_what_the_reference_catches(name):
    doc = MALFORMED[name]
    got = validate_chrome(doc)
    assert got == j_validate_chrome(doc)
    assert bool(got) == (name != "nested_ok")


def test_profiler_equals_the_reference():
    ticks = iter(float(i) for i in range(1000))
    jticks = iter(float(i) for i in range(1000))
    tr, jtr = Tracer(clock=lambda: next(ticks)), JTracer(clock=lambda: next(jticks))
    p, jp = PhaseProfiler(tr), JPhaseProfiler(jtr)
    calls = [("record", "decode", 0.5, 10), ("record", "decode", 0.25, 4),
             ("record", "prefill", 0.125, 0), ("cache", "decode_step", 1),
             ("cache", "decode_step", 1), ("cache", "decode_step", 3),
             ("cache", "prefill", None), ("cache", "prefill", 0), ("cache", "prefill", 1),
             ("record", "spec", 1.0, 7)]
    for prof in (p, jp):
        for call in calls:
            if call[0] == "record":
                prof.record(call[1], call[2], tokens=call[3])
            else:
                prof.observe_cache(call[1], call[2])
    assert p.snapshot() == jp.snapshot()
    assert p.describe() == jp.describe()
    assert p.recompiles == 3
    assert tr.counters == jtr.counters
    assert [dataclasses.astuple(e) for e in tr.events] == [dataclasses.astuple(e) for e in jtr.events]


class TestTracer:
    def test_ring_capacity_and_dropped(self):
        tr = Tracer(TraceConfig(capacity=4), clock=lambda: 0.0)
        for i in range(10):
            tr.emit("token", rid=i)
        assert tr.emitted == 10 and len(tr.events) == 4 and tr.dropped == 6
        assert [e.rid for e in tr.events] == [6, 7, 8, 9]

    def test_counters_gauges_and_step_stamp(self):
        tr = Tracer(clock=lambda: 1.5)
        tr.inc("x")
        tr.inc("x", 2)
        tr.set_gauge("g", 7)
        tr.step = 3
        tr.emit("decode_step")
        tr.emit("submit", step=9)
        assert tr.counters["x"] == 3 and tr.gauges["g"] == 7.0
        assert [e.step for e in tr.events] == [3, 9] and tr.events[0].ts == 1.5

    def test_null_tracer_is_inert_and_refuses_export(self):
        NULL_TRACER.emit("token", rid=1)
        NULL_TRACER.inc("x")
        assert not NULL_TRACER.enabled and NULL_TRACER.events == ()
        for call in (NULL_TRACER.chrome, NULL_TRACER.prometheus,
                     NULL_TRACER.precision_timeline, NULL_TRACER.format_timeline):
            with pytest.raises(RuntimeError, match="tracing is off"):
                call()
        with pytest.raises(RuntimeError, match="tracing is off"):
            NULL_TRACER.export_chrome("unused.json")

    def test_tracer_exporters_read_the_ring(self, tmp_path):
        ticks = iter(float(i) for i in range(100))
        tr = Tracer(clock=lambda: next(ticks))
        jticks = iter(float(i) for i in range(100))
        jtr = JTracer(clock=lambda: next(jticks))
        for t in (tr, jtr):
            for ts, step, kind, rid, slot, cause, data in DECISIONS:
                t.step = step
                t.emit(kind, rid=rid, slot=slot, cause=cause, **(data or {}))
            t.inc("tokens_out", 3)
            t.set_gauge("active_slots", 2)
        assert tr.chrome() == jtr.chrome()
        assert tr.prometheus() == jtr.prometheus()
        assert tr.precision_timeline() == jtr.precision_timeline()
        assert tr.format_timeline() == jtr.format_timeline()
        doc = tr.export_chrome(str(tmp_path / "t.json"))
        assert json.loads((tmp_path / "t.json").read_text()) == doc == jtr.chrome()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    _, _, model, params = make_pair("native_f32", n_layers=2)
    return model, params


@pytest.fixture(scope="module")
def tiny_m24():
    _, _, model, params = make_pair("M24", n_layers=2)
    return model, params


def _reqs(vocab, n, *, prompt_len=6, max_new=5, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, prompt_len).astype(np.int32),
                    max_new=max_new, rid=i, **kw) for i in range(n)]


class TestEngineTracing:
    def test_traced_tokens_equal_untraced(self, tiny):
        model, params = tiny
        reqs = _reqs(model.cfg.vocab, 4)
        base = ServeConfig(batch_slots=2, max_len=24)
        e_off = ServeEngine(model, params, config=base)
        e_on = ServeEngine(model, params, config=dataclasses.replace(base, trace=TraceConfig()))
        assert e_off.tracer is NULL_TRACER and e_on.tracer.enabled
        assert e_off.generate_batch(reqs) == e_on.generate_batch(reqs)
        assert e_off.decode_compile_count == e_on.decode_compile_count
        assert e_off.graph_capture_count == e_on.graph_capture_count == 0

    def test_trace_true_means_default_config(self, tiny):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=1, max_len=16, trace=True))
        assert eng.tracer.enabled and eng.tracer.config.capacity == TraceConfig().capacity
        assert eng.profiler.tracer is eng.tracer

    def test_plain_run_replays_exports_and_profiles(self, tiny, tmp_path):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=24, trace=TraceConfig()))
        eng.generate_batch(_reqs(model.cfg.vocab, 4))
        log = check_replay(eng)
        assert sum(1 for _, k, _, _ in log if k == SUBMIT) == 4
        assert sum(1 for _, k, _, _ in log if k == FINISH) == 4
        path = tmp_path / "trace.json"
        doc = eng.tracer.export_chrome(str(path))
        assert validate_chrome(doc) == [] and validate_chrome(json.loads(path.read_text())) == []
        assert eng.tracer.counters["tokens_out"] == 20
        assert "repro_obs_tokens_out 20" in eng.tracer.prometheus()
        snap = eng.profiler.snapshot()
        assert snap["recompiles"] == 0  # nothing captured or built on the CPU
        assert snap["phases"]["prefill"]["calls"] == 4
        assert snap["phases"]["decode"]["calls"] == eng.metrics.decode_steps
        assert snap["phases"]["decode"]["tokens"] == 16
        assert eng.tracer.counters["decode_calls"] == eng.metrics.decode_steps
        spans = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] == 1]
        assert spans.count("prefill") == 4 and spans.count("decode_step") == eng.metrics.decode_steps

    def test_zero_budget_request_traces_done_without_admit(self, tiny):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=1, max_len=16, trace=TraceConfig()))
        eng.submit(Request(prompt=np.arange(5, dtype=np.int32), max_new=0, rid=0))
        eng.drain()
        assert [e.kind for e in eng.tracer.events if e.rid == 0] == ["submit", "done"]
        done = [e for e in eng.tracer.events if e.kind == "done"][0]
        assert done.cause == "zero_budget" and done.slot == -1
        check_replay(eng)

    def test_multi_tenant_preemption_replay_and_causes(self, tiny):
        model, params = tiny
        sched = SchedulingConfig(
            tenants=[Tenant("hot", priority=0), Tenant("bulk", priority=2)],
            classes=[RequestClass("c", prompt_len=5, max_new=6)], min_quantum=1)
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=1, max_len=24, scheduling=sched, trace=TraceConfig()))
        rng = np.random.default_rng(0)
        eng.submit(Request(prompt=rng.integers(0, 512, 5).astype(np.int32), max_new=6,
                           rid=0, tenant="bulk", rclass="c"))
        eng.step()
        eng.step()
        eng.submit(Request(prompt=rng.integers(0, 512, 5).astype(np.int32), max_new=3,
                           rid=1, tenant="hot", rclass="c"))
        eng.drain()
        events = list(eng.tracer.events)
        pre = [e for e in events if e.kind == "preempt"]
        assert pre and all(e.cause == "priority" for e in pre)
        assert any(e.kind == "preempt_plan" for e in events)
        assert any(e.kind == "resume" and e.rid == 0 for e in events)
        check_replay(eng)
        assert validate_chrome(eng.tracer.chrome()) == []

    def test_spec_round_events_and_profile(self, tiny):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=32, spec=SpecConfig(k=2, draft_shift=1), trace=TraceConfig()))
        eng.generate_batch(_reqs(model.cfg.vocab, 3, max_new=6))
        rounds = [e for e in eng.tracer.events if e.kind == "spec_round"]
        assert rounds
        for e in rounds:
            assert e.data["drafted"] == eng.spec.k * e.data["n_active"]
            assert 0 <= e.data["agreed"] <= e.data["drafted"]
        assert eng.tracer.counters["spec_rounds"] == len(rounds)
        assert eng.profiler.phases["spec"].calls == len(rounds)
        assert eng.profiler.phases["spec"].tokens == eng.metrics.summary()["tokens_out"] - 3
        assert eng.profiler.recompiles == 0
        check_replay(eng)

    def test_paged_speculative_run_traces_cache_events_and_replays(self, tiny):
        """The dense counterpart of the reference's hybrid paged trace: a
        speculative paged run whose verify appends wrap into shared prompt
        pages, so copy-on-write forks fire."""
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=3, max_len=24, spec=SpecConfig(k=3, draft_shift=1),
            cache=CacheConfig(layout="paged", page_size=4), trace=TraceConfig()))
        prompt = np.asarray([7] * 8, np.int32)  # shared prefix -> shared pages
        for i in range(3):
            eng.submit(Request(prompt=np.append(prompt, i).astype(np.int32), max_new=30, rid=i))
        eng.drain()
        kinds = {e.kind for e in eng.tracer.events}
        assert "prefix_share" in kinds and "cow_fork" in kinds
        assert all(e.cause == "shared_page_write"
                   for e in eng.tracer.events if e.kind == "cow_fork")
        check_replay(eng)
        assert validate_chrome(eng.tracer.chrome()) == []

    def test_adapt_run_emits_decisions_and_timeline(self, tiny):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=32, adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=2),
            trace=TraceConfig()))
        eng.generate_batch(_reqs(model.cfg.vocab, 3, max_new=8))
        events = list(eng.tracer.events)
        decisions = [e for e in events if e.kind == "adapt_decision"]
        assert decisions and all(e.cause in ("hold", "cooldown", "err_violation",
                                             "latency_pressure", "clean_streak")
                                 for e in decisions)
        switches = [e for e in events if e.kind == "mode_switch"]
        assert switches and len(switches) == eng.metrics.mode_switches
        for e in switches:
            assert e.cause in ("err_violation", "latency_pressure", "clean_streak")
            assert set(e.data["sites"]) == set(eng.mode_table.modes())
        rows = eng.tracer.precision_timeline()
        assert rows and rows[0]["mode"] is not None
        assert any(r["sites"] is not None for r in rows)
        check_replay(eng)

    def test_per_tenant_adapt_run_stamps_the_tenant(self, tiny_m24):
        model, params = tiny_m24
        sched = SchedulingConfig(tenants=[Tenant("a"), Tenant("b", accuracy=1e-9)])
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=32, scheduling=sched,
            adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1), trace=TraceConfig()))
        reqs = _reqs(model.cfg.vocab, 4, max_new=8)
        for i, r in enumerate(reqs):
            eng.submit(dataclasses.replace(r, tenant="a" if i % 2 else "b"))
        eng.drain()
        events = list(eng.tracer.events)
        switches = [e for e in events if e.kind == "mode_switch"]
        # tenant a's controller relaxes from M24 (its residual is 0 there);
        # tenant b's budget holds it at the top
        assert switches and {e.data["tenant"] for e in switches} == {"a"}
        assert {e.data["controller"] for e in events if e.kind == "adapt_decision"} == \
            {"adapt/a", "adapt/b"}
        assert eng.tenant_tables["b"].label() == "M24"
        # the bound label follows the most precise active table
        modes = {e.data["mode"] for e in events if e.kind == "decode_step"}
        assert "M24" in modes
        check_replay(eng)
        assert validate_chrome(eng.tracer.chrome()) == []

    def test_no_emit_inside_a_compiled_body(self, tiny):
        """A captured body's host code runs once, at capture: every emit
        must sit outside it.  Run each body eagerly and count events."""
        model, params = tiny
        cases = [
            dict(),
            dict(adapt=AdaptConfig(slo=SLO(max_err=0.5))),
            dict(spec=SpecConfig(k=2, draft_shift=1)),
        ]
        for over in cases:
            eng = ServeEngine(model, params, config=ServeConfig(
                batch_slots=2, max_len=24, trace=TraceConfig(), **over))
            eng.submit(_reqs(model.cfg.vocab, 1)[0])
            eng.step()
            for graph in (eng._step_graph, eng._round_graph, eng._probe_graph):
                if graph is None:
                    continue
                before = (eng.tracer.emitted, dict(eng.tracer.counters), dict(eng.tracer.gauges))
                graph.fn()
                assert (eng.tracer.emitted, eng.tracer.counters, eng.tracer.gauges) == before, \
                    graph.name

    def test_describe_consolidation(self, tiny):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=1, max_len=16, trace=TraceConfig()))
        eng.generate_batch(_reqs(model.cfg.vocab, 1))
        d = eng.describe()
        assert {"plans", "adaptation", "speculation", "tenancy", "cache", "trace",
                "profile"} <= set(d)
        assert d["profile"].endswith("recompiles: 0") and "prefill: 1 calls" in d["profile"]
        assert eng.describe_plans() == d["plans"]
        assert eng.describe_cache() == d["cache"]
        block = eng.format_describe()
        for key in d:
            assert f"-- {key} --" in block
        e2 = ServeEngine(model, params, config=ServeConfig(batch_slots=1, max_len=16))
        assert set(e2.describe()) == {"plans", "adaptation", "speculation", "tenancy", "cache"}


# ---------------------------------------------------------------------------
# host spans (Tracer.span) and device spans (repro_torch.obs.device)
# ---------------------------------------------------------------------------


class TestHostSpans:
    def test_span_ids_parents_and_explicit_start(self):
        ticks = iter(float(i) for i in range(100))
        tr = Tracer(clock=lambda: next(ticks))
        tr.step = 4
        with tr.span("step") as outer:
            with tr.span("prefill", rid=7, slot=1, prompt_len=3) as inner:
                pass
            with tr.span("decode_step", n_active=2):
                pass
        outer.data["late"] = True  # a read after the span's end lands in its event
        ev = {e.kind: e for e in tr.events}
        assert [e.kind for e in tr.events] == ["prefill", "decode_step", "step"]
        assert ev["step"].data["parent"] is None
        assert ev["prefill"].data["parent"] == ev["decode_step"].data["parent"] == \
            ev["step"].data["span"]
        assert len({e.data["span"] for e in tr.events}) == 3
        for e in tr.events:
            assert e.data["t0"] == e.ts - e.data["dur_ms"] / 1e3 and e.step == 4
        assert ev["prefill"].rid == 7 and ev["prefill"].slot == 1
        assert ev["prefill"].data["prompt_len"] == 3 and inner.event is ev["prefill"]
        assert ev["step"].data["late"] and tr.emitted == 3

    def test_span_opens_a_profiler_range_only_while_recording(self):
        from torch.profiler import ProfilerActivity, profile

        tr = Tracer()
        with tr.span("outside"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tr.span("decode_step"):
                with tr.span("decode.sync"):
                    pass
        names = {e.name for e in prof.events()}
        assert {"decode_step", "decode.sync"} <= names and "outside" not in names

    def test_null_tracer_span_is_a_shared_no_op(self):
        a = NULL_TRACER.span("step", rid=1)
        assert a is NULL_TRACER.span("decode_step")
        with a as sp:
            pass
        assert sp is None
        assert NULL_TRACER.events == () and NULL_TRACER.emitted == 0

    def test_chrome_renders_spans_from_their_own_start(self):
        ticks = iter([10.0, 10.5, 11.0, 11.5, 12.0])
        tr = Tracer(clock=lambda: next(ticks))
        with tr.span("step"):
            with tr.span("decode.replay"):
                pass
            tr.emit("token", rid=0)
        doc = tr.chrome()
        spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
        assert spans["step"]["ts"] == 0.0 and spans["step"]["dur"] == pytest.approx(2e6)
        assert spans["decode.replay"]["ts"] == pytest.approx(0.5e6)
        assert spans["decode.replay"]["dur"] == pytest.approx(0.5e6)
        assert validate_chrome(doc) == []


@pytest.fixture(scope="module")
def tiny_moe():
    _, _, model, params = make_pair("native_f32", arch="phi3.5-moe-42b-a6.6b", n_layers=2)
    return model, params


#: each span's children; every other span is a child of ``step``
CHILDREN = {"prefill": ("prefill.forward", "prefill.scatter", "prefill.sample"),
            "decode_step": ("decode.replay", "decode.sync"),
            "spec_round": ("decode.replay", "decode.sync")}
TOP = ("schedule", "prefill", "pages", "decode.inputs", "decode_step", "spec_round",
       "decode.emit", "adapt", "page_tick")


def _traced_run(model, params, **over):
    eng = ServeEngine(model, params, config=ServeConfig(
        batch_slots=2, max_len=32, trace=TraceConfig(), **over))
    out = eng.generate_batch(_reqs(model.cfg.vocab, 3, max_new=5))
    return eng, out


class TestEngineSpans:
    @pytest.mark.parametrize("family", ["dense", "moe"])
    def test_span_tree_nests_and_exports(self, tiny, tiny_moe, family):
        model, params = tiny if family == "dense" else tiny_moe
        eng, _ = _traced_run(model, params)
        events = list(eng.tracer.events)
        spans = {e.data["span"]: e for e in events if e.data and "span" in e.data}
        kinds = {e.kind for e in spans.values()}
        assert {"step", "schedule", "prefill", "pages", "decode.inputs", "decode_step",
                "decode.emit"} | set(CHILDREN["prefill"]) | set(CHILDREN["decode_step"]) == kinds
        for e in spans.values():
            parent = spans.get(e.data["parent"])
            if e.kind == "step":
                assert parent is None
                continue
            assert parent is not None, e.kind
            assert parent.data["t0"] <= e.data["t0"] and e.ts <= parent.ts
            assert e.kind in CHILDREN.get(parent.kind, TOP), (parent.kind, e.kind)
        doc = eng.tracer.chrome()
        assert validate_chrome(doc) == []
        x = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] == 1]
        assert sum(e["name"] == "step" for e in x) == eng.scheduler.clock
        check_replay(eng)

    def test_adapt_and_page_tick_are_spans_of_the_step(self, tiny):
        model, params = tiny
        eng, _ = _traced_run(model, params, adapt=AdaptConfig(slo=SLO(max_err=0.5),
                                                              adapt_every=2),
                             cache=CacheConfig(layout="paged", page_size=4))
        spans = {e.data["span"]: e for e in eng.tracer.events if e.data and "span" in e.data}
        for kind in ("adapt", "page_tick"):
            got = [e for e in spans.values() if e.kind == kind]
            assert got and all(spans[e.data["parent"]].kind == "step" for e in got)
        assert validate_chrome(eng.tracer.chrome()) == []

    def test_prefill_and_decode_step_keep_their_boundaries(self, tiny):
        """One ``prefill`` a request and one ``decode_step`` a step, as
        before; each span's explicit start is the old end-stamp
        reconstruction (``ts - dur_ms``), and its parts lie inside it."""
        model, params = tiny
        eng, _ = _traced_run(model, params)
        events = list(eng.tracer.events)
        steps = [e for e in events if e.kind == "decode_step"]
        assert len(steps) == eng.metrics.decode_steps
        assert len([e for e in events if e.kind == "prefill"]) == 3
        by_id = {e.data["span"]: e for e in events if e.data and "span" in e.data}
        for e in by_id.values():
            assert e.ts - e.data["dur_ms"] / 1e3 == pytest.approx(e.data["t0"], abs=1e-9)
            parent = by_id.get(e.data["parent"])
            if parent is not None and parent.kind in ("prefill", "decode_step"):
                assert parent.data["t0"] <= e.data["t0"] and e.ts <= parent.ts
        assert steps[-1].data["n_active"] >= 1 and steps[-1].data["mode"]

    @pytest.mark.parametrize("family", ["dense", "moe"])
    def test_device_sites_name_every_block_with_per_layer_counts(self, tiny, tiny_moe, family):
        model, params = tiny if family == "dense" else tiny_moe
        eng, _ = _traced_run(model, params)
        n_layers = model.cfg.n_layers
        expert = ("ffn/moe_expert", "ffn/router") if family == "moe" else ("ffn/mlp_up",
                                                                          "ffn/mlp_down")
        steps = [e.data for e in eng.tracer.events if e.kind == "decode_step"]
        for d in steps:
            n, ms = d["sites_n"], d["sites_ms"]
            assert n["attention"] == n["ffn"] == n_layers
            assert n["embed"] == n["head"] == n["head/logits"] == n["sample"] == 1
            assert n["state"] == 2  # the merge and the copy-back
            for op in ("attention/qkv", "attention/attn_qk", "attention/attn_av",
                       "attention/out") + expert:
                assert n[op] >= n_layers, op
            assert "scatter" not in n
            blocks = ms["attention"] + ms["ffn"] + ms["state"]
            assert 0.0 < blocks <= d["device_ms"]
            assert ms["attention"] >= ms["attention/attn_qk"]
        for d in (e.data for e in eng.tracer.events if e.kind == "prefill"):
            assert d["sites_n"]["scatter"] == d["sites_n"]["sample"] == 1
            assert d["sites_n"]["attention"] == n_layers and "state" not in d["sites_n"]
        c = eng.tracer.counters
        assert c["device_ms/decode_step"] == pytest.approx(sum(d["device_ms"] for d in steps))
        assert c["device_ms/decode_step/attention"] > 0.0 and c["device_ms/prefill/scatter"] > 0.0
        assert "repro_obs_device_ms_decode_step_ffn " in eng.tracer.prometheus()

    def test_spec_round_is_a_span_with_its_counts(self, tiny):
        model, params = tiny
        eng, _ = _traced_run(model, params, spec=SpecConfig(k=2, draft_shift=1))
        rounds = [e for e in eng.tracer.events if e.kind == "spec_round"]
        assert rounds and all(e.data["drafted"] == 2 * e.data["n_active"] for e in rounds)
        spans = {e.data["span"]: e.kind for e in eng.tracer.events if e.data and "span" in e.data}
        for e in eng.tracer.events:
            if e.kind in ("decode.replay", "decode.sync"):
                assert spans[e.data["parent"]] == "spec_round"
        assert all(e.data["sites_n"]["attention"] >= model.cfg.n_layers for e in rounds)
        assert validate_chrome(eng.tracer.chrome()) == []

    @pytest.mark.parametrize("over", [{}, {"spec": SpecConfig(k=2, draft_shift=1)},
                                      {"adapt": AdaptConfig(slo=SLO(max_err=0.5))}],
                             ids=["plain", "spec", "adapt"])
    @pytest.mark.parametrize("family", ["dense", "moe"])
    def test_tracing_off_opens_no_recording(self, tiny, tiny_moe, family, over, monkeypatch):
        """Tracing off, no device span is ever recorded and no timing event
        made; the tokens are those of a traced run."""
        import torch

        from repro_torch.obs import device as obs_device

        model, params = tiny if family == "dense" else tiny_moe
        opened, made = [], []
        enter = obs_device.Recording.__enter__
        monkeypatch.setattr(obs_device.Recording, "__enter__",
                            lambda self: opened.append(1) or enter(self))
        monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: made.append(1))
        reqs = _reqs(model.cfg.vocab, 3, max_new=5)
        base = ServeConfig(batch_slots=2, max_len=32, **over)
        off = ServeEngine(model, params, config=base).generate_batch(reqs)
        assert opened == [] and made == []
        on = ServeEngine(model, params, config=dataclasses.replace(
            base, trace=TraceConfig())).generate_batch(reqs)
        assert on == off and opened and made == []  # the CPU stamps the host clock
