"""Port vs reference, the serving slice: scheduler, continuous batching,
park/resume, the adaptive engine and the launcher, on the CPU at the smoke
size (2 layers, d_model 128, vocab 512).  Parameters are made with numpy and
handed to both packages (see ``test_torch_common.numpy_params``).

Tokens against the reference's engine are compared under the margin rule:
only where the reference's top-2 logit margin exceeds the logit tolerance of
``test_torch_model`` may a greedy token be required to agree; a request is
compared up to its first undecided token (after it the two streams may
legitimately condition on different tokens)."""
import dataclasses
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.tenancy import RequestClass as JRequestClass
from repro.serve.tenancy import Tenant as JTenant

from repro_torch.adapt import SLO, HysteresisController, ModeTable, bind_modes, runtime_mode_for
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.kernels import build
from repro_torch.launch import serve as launch_serve
from repro_torch.models.layers import pmm
from repro_torch.plan import MODE_REL_ERROR
from repro_torch.serve import (
    AdaptConfig,
    CacheConfig,
    Request,
    RequestClass,
    SchedulingConfig,
    ServeConfig,
    ServeEngine,
    Tenant,
    ragged_requests,
)
from repro_torch.serve.engine import row_select
from repro_torch.serve.scheduler import Scheduler
from repro_torch.spec import SpecConfig

from test_torch_common import CACHE_FLIP_SHARE, CACHE_QUANTUM, FACTOR, make_pair


def _req(rid, n=4, max_new=4, vocab=512, seed=None, **kw):
    rng = np.random.default_rng(rid if seed is None else seed)
    return Request(rng.integers(0, vocab, n).astype(np.int32), max_new, rid=rid, **kw)


@pytest.fixture(scope="module")
def pair():
    """(reference model, reference params, port model, port params) at two
    layers under native_f32."""
    return make_pair("native_f32", n_layers=2)


@pytest.fixture(scope="module")
def tiny(pair):
    return pair[2], pair[3]


def _solo(model, params, req, max_len=48):
    eng = ServeEngine(model, params, config=ServeConfig(batch_slots=1, max_len=max_len))
    return eng.generate_batch([dataclasses.replace(req)])[req.rid]


# ---------------------------------------------------------------------------
# scheduler: the port's copy against the reference's on one request trace
# ---------------------------------------------------------------------------


def _drive(sched_cls, req_cls, tenant_cls, class_cls, policy):
    """Run a fixed multi-tenant request trace through a scheduler with a
    host-only stand-in for the engine (every active ticket emits one token a
    step) and return the event log."""
    tenants = [tenant_cls("interactive", priority=0, share=2.0),
               tenant_cls("bulk", priority=2, share=1.0)]
    classes = [class_cls("chat", slo_steps=6, prompt_len=4, max_new=3),
               class_cls("batch", prompt_len=9, max_new=7)]
    sch = sched_cls(3, 16, tenants=tenants, classes=classes, policy=policy,
                    preempt=True, aging_steps=4, min_quantum=2)
    rng = np.random.default_rng(0)
    arrivals = {  # step -> [(rid, tenant, class, prompt_len, max_new)]
        0: [(0, "bulk", "batch", 9, 7), (1, "bulk", "batch", 5, 6), (2, "bulk", "batch", 7, 12),
            (3, "bulk", "batch", 3, 5)],
        2: [(10, "interactive", "chat", 4, 3)],
        3: [(11, "interactive", "chat", 2, 3), (4, "bulk", "batch", 15, 9)],
        7: [(12, "interactive", "chat", 4, 2), (5, "bulk", "batch", 16, 4)],
    }
    log = []
    step = 0
    while step < 64 and (sch.has_work() or any(s >= step for s in arrivals)):
        for rid, tenant, rclass, n, max_new in arrivals.get(step, ()):
            sch.submit(req_cls(rng.integers(0, 64, n).astype(np.int32), max_new, rid=rid,
                               tenant=tenant, rclass=rclass))
            t = sch.tickets[rid]
            log.append((step, "submit", rid, t.budget, t.priority, t.deadline))
        sch.tick()
        for victim in sch.plan_preemptions():
            log.append((step, "preempt", victim.rid, victim.slot))
            sch.preempt(victim.rid)
        for slot, ticket in sch.admit():
            log.append((step, "admit", ticket.rid, slot, len(ticket.tokens)))
            if slot >= 0 and not ticket.tokens:
                ticket.tokens.append(0)
                if len(ticket.tokens) >= ticket.budget:
                    sch.complete(ticket.rid)
                else:
                    sch.start_decode(ticket.rid)
        for slot in sorted(sch.by_slot):
            ticket = sch.by_slot[slot]
            ticket.tokens.append(len(ticket.tokens))
            if len(ticket.tokens) >= ticket.budget:
                log.append((step, "done", ticket.rid, slot, len(ticket.tokens)))
                sch.complete(ticket.rid)
        log.append((step, "state", sch.n_active, sch.n_waiting, sorted(sch.free)))
        step += 1
    log.append(("end", sch.preemptions, sch.max_wait_steps, sorted(sch.completed)))
    return log


@pytest.mark.parametrize("policy", ["priority", "fifo"])
def test_scheduler_event_log_equals_reference(policy):
    want = _drive(JScheduler, JRequest, JTenant, JRequestClass, policy)
    got = _drive(Scheduler, Request, Tenant, RequestClass, policy)
    assert got == want
    assert any(e[1] == "done" for e in got if e[0] != "end")
    if policy == "priority":
        assert any(e[1] == "preempt" for e in got if e[0] != "end")


def test_scheduler_submit_validation_and_budget_clamp():
    sch = Scheduler(2, 16)
    with pytest.raises(ValueError):
        sch.submit(Request(np.zeros((0,), np.int32), 4, rid=0))
    sch.submit(_req(1, n=14, max_new=50))
    assert sch.tickets[1].budget == 3  # evicted at max_len: 16 - 14 + 1
    with pytest.raises(ValueError):
        sch.submit(_req(1, n=4))  # duplicate rid
    with pytest.raises(ValueError):
        sch.submit(_req(2, n=4, tenant="nobody"))


# ---------------------------------------------------------------------------
# continuous batching inside the port
# ---------------------------------------------------------------------------


class TestContinuousBatching:
    def test_ragged_batch_matches_solo(self, tiny):
        model, params = tiny
        reqs = [_req(0, n=3, max_new=5), _req(1, n=9, max_new=3), _req(2, n=6, max_new=4)]
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=3, max_len=48))
        outs = eng.generate_batch(reqs)
        for r in reqs:
            assert outs[r.rid] == _solo(model, params, r), f"rid {r.rid}"

    def test_budget_clamp_no_tokens_past_budget(self, tiny):
        model, params = tiny
        reqs = [_req(0, n=4, max_new=2), _req(1, n=4, max_new=9), _req(2, n=14, max_new=50)]
        eng = ServeEngine(model, params, batch_slots=3, max_len=16)  # legacy kwargs
        outs = eng.generate_batch(reqs)
        assert [len(outs[i]) for i in range(3)] == [2, 9, 3]

    def test_mid_flight_join_matches_solo(self, tiny):
        model, params = tiny
        a, b = _req(0, n=7, max_new=8), _req(1, n=4, max_new=5)
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=48))
        eng.submit(a)
        for _ in range(3):
            eng.step()  # a is 4 tokens deep when b arrives
        eng.submit(b)
        done = eng.drain()
        assert done[0] == _solo(model, params, a) and done[1] == _solo(model, params, b)

    def test_slot_reuse_more_requests_than_slots(self, tiny):
        model, params = tiny
        reqs = [_req(i, n=3 + i, max_new=3) for i in range(5)]
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=32))
        outs = eng.generate_batch(reqs)
        assert sorted(outs) == [0, 1, 2, 3, 4]
        for r in reqs:
            assert outs[r.rid] == _solo(model, params, r, max_len=32)
        assert sorted(eng.scheduler.free) == [0, 1]

    def test_streaming_events_and_metrics(self, tiny):
        model, params = tiny
        r = _req(0, n=5, max_new=4)
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=1, max_len=32))
        eng.submit(r)
        events = []
        while eng.scheduler.has_work():
            events.extend(eng.step())
        assert [rid for rid, _ in events] == [0, 0, 0, 0]
        assert [t for _, t in events] == _solo(model, params, r, max_len=32)
        s = eng.metrics.summary()
        assert s["tokens_out"] == 4 and s["requests"] == s["completed"] == 1
        assert s["ttft_mean_s"] > 0 and s["latency_mean_s"] >= s["ttft_mean_s"]
        assert set(s["plan_cache"]) == {"hits", "misses", "entries"}

    def test_int8_cache_batched_matches_solo(self):
        _, _, model, params = make_pair("native_f32", "int8", n_layers=2)
        reqs = [_req(0, n=5, max_new=4), _req(1, n=8, max_new=4)]
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=32))
        outs = eng.generate_batch(reqs)
        for r in reqs:
            assert outs[r.rid] == _solo(model, params, r, max_len=32)

    def test_row_select_keeps_inactive_rows_exactly(self):
        old = torch.arange(24, dtype=torch.float32).reshape(3, 4, 2)
        new = old + 100
        active = torch.tensor([True, False, True])
        out = row_select(0, new, old, active)
        assert torch.equal(out[1], old[1]) and torch.equal(out[0], new[0])
        assert torch.equal(row_select(1, new.permute(1, 0, 2), old.permute(1, 0, 2), active)[:, 1],
                           old[1])
        assert row_select(-1, new, old, active) is new

    def test_open_loop_launcher_path(self, tiny):
        model, params = tiny
        reqs = ragged_requests(4, model.cfg.vocab, 10, 6, np.random.default_rng(0))
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=24))
        outs = launch_serve.run_open_loop(eng, reqs, 200.0, np.random.default_rng(0))
        assert sorted(outs) == [0, 1, 2, 3]
        for r in reqs:
            assert len(outs[r.rid]) == eng.scheduler.tickets[r.rid].budget
        assert "unplanned" in eng.describe_plans() and "dense" in eng.describe_cache()


class TestParkResume:
    def test_preempted_request_stream_is_exact(self, tiny):
        model, params = tiny
        tenants = [Tenant("interactive", priority=0), Tenant("bulk", priority=2)]
        classes = [RequestClass("chat", slo_steps=8), RequestClass("batch")]
        cfg = ServeConfig(batch_slots=1, max_len=48,
                          scheduling=SchedulingConfig(tenants=tenants, classes=classes,
                                                      min_quantum=2))
        bulk = _req(0, n=6, max_new=10, tenant="bulk", rclass="batch")
        chat = _req(1, n=4, max_new=3, tenant="interactive", rclass="chat")
        eng = ServeEngine(model, params, config=cfg)
        eng.submit(bulk)
        for _ in range(3):
            eng.step()
        eng.submit(chat)  # more urgent: parks the bulk request's state row
        done = eng.drain()
        assert eng.scheduler.preemptions == 1 and not eng._parked
        plain = dataclasses.replace(bulk, tenant="default", rclass="default")
        assert done[0] == _solo(model, params, plain)
        assert done[1] == _solo(model, params,
                                dataclasses.replace(chat, tenant="default", rclass="default"))
        assert "1 preemptions" in eng.describe_tenancy()

    def test_gather_scatter_roundtrip_is_exact(self, tiny):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=3, max_len=24))
        eng.generate_batch([_req(0, n=5, max_new=3)])
        eng.submit(_req(1, n=7, max_new=6))
        eng.step()
        slot = eng.scheduler.tickets[1].slot
        row = eng.layout.gather_row(eng.state, slot)
        assert tuple(row.position.shape) == (1,)
        moved = eng.layout.scatter_row(eng.layout.free_row(eng.state, slot), row, 2)
        again = eng.layout.gather_row(moved, 2)
        for a, b in zip(row.caches["seg0_dense"], again.caches["seg0_dense"]):
            assert torch.equal(a.k, b.k) and torch.equal(a.pos, b.pos)
            assert torch.equal(a.length, b.length)
        # the write touched row 2 only: every other row is copied bit for bit
        for a, b in zip(eng.state.caches["seg0_dense"], moved.caches["seg0_dense"]):
            assert torch.equal(a.k[:2], b.k[:2]) and torch.equal(a.pos[:2], b.pos[:2])


# ---------------------------------------------------------------------------
# adaptation
# ---------------------------------------------------------------------------


class TestAdaptation:
    def test_mode_table_and_binding(self, rng):
        table = ModeTable.from_policy(PrecisionPolicy(default=Mode.M16))
        assert table.label() == "M16" and not table.at_max and not table.at_min
        assert all(isinstance(v, int) for v in table.scalars().values())  # host ints
        assert set(table.scalars_shifted(5).values()) == {int(Mode.M24)}  # clamped
        assert runtime_mode_for("mlp_up") is None
        with bind_modes(table.scalars()):
            assert runtime_mode_for("mlp_up") == int(Mode.M16)
        assert runtime_mode_for("mlp_up") is None
        with pytest.raises(ValueError, match="not runtime-switchable"):
            ModeTable({"mlp_up": Mode.M8}, max_mode=Mode.M48)
        with pytest.raises(ValueError):
            ModeTable({})

    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_pmm_reads_the_bound_mode(self, rng, impl):
        x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
        policy = PrecisionPolicy(default=Mode.M8, impl=impl)
        unbound = pmm(x, w, "mlp_up", policy)
        with bind_modes({"mlp_up": int(Mode.M24)}):
            bound = pmm(x, w, "mlp_up", policy)
        exact = x.double() @ w.double()
        assert (bound.double() - exact).abs().max() < (unbound.double() - exact).abs().max() / 50
        want = pmm(x, w, "mlp_up", PrecisionPolicy(default=Mode.M24, impl=impl))
        assert torch.equal(bound, want)  # the mode-map path == the static path, bitwise

    def test_controller_hysteresis(self):
        c = HysteresisController(SLO(max_err=0.1), cooldown=2)
        assert c.observe(1, 0.5, None, can_up=True, can_down=True) == 1
        assert c.observe(2, 0.5, None, can_up=True, can_down=True) == 0  # cooling down
        assert c.observe(9, 0.05, 0.5, can_up=True, can_down=True) == 0  # down is unsafe
        assert c.observe(10, 0.001, 0.002, can_up=True, can_down=True) == -1
        assert (c.up_shifts, c.down_shifts) == (1, 1)
        with pytest.raises(ValueError):
            SLO(max_err=0.0)

    def test_forced_hot_batch_shifts_up_and_back_and_builds_nothing(self):
        _, _, model, params = make_pair("M8", n_layers=2)
        cfg = ServeConfig(batch_slots=2, max_len=48,
                          adapt=AdaptConfig(slo=SLO(max_err=0.1), adapt_every=1))
        eng = ServeEngine(model, params, config=cfg)
        assert eng.mode_table.label() == "M8"
        real_probe = eng._probe_fn
        forced: list[tuple[float, float]] = []

        def probe(*args):
            real = real_probe(*args)  # the real shadow forward still runs
            assert all(float(r) >= 0 for r in real)
            return forced.pop(0) if forced else (0.001, 0.002)

        eng._probe_fn = probe
        # a hot batch: the residual jumps over the SLO for three probes
        forced[:] = [(0.5, 0.9)] * 3
        eng.submit(_req(0, n=5, max_new=14))
        eng.submit(_req(1, n=7, max_new=14))
        labels = []
        while eng.scheduler.has_work():
            eng.step()
            labels.append(eng.mode_table.label())
        assert "M16" in labels or "M24" in labels  # shifted up ...
        assert labels[-1] == "M8"  # ... and back down once the batch cooled
        assert eng.controller.up_shifts >= 1 and eng.controller.down_shifts >= 1
        assert eng.metrics.mode_switches >= 2
        timeline = [lab for _, lab in eng.metrics.mode_timeline]
        assert timeline[0] == "M8" and timeline[-1] == "M8" and len(timeline) >= 3
        assert eng.kernel_build_count == eng.decode_compile_count == build.BUILD_COUNT == 0
        assert "switches" in eng.describe_adaptation()

    def test_real_probe_orders_modes_and_monitor_mode_holds(self):
        _, _, model, params = make_pair("M8", n_layers=2)
        cfg = ServeConfig(batch_slots=2, max_len=32,
                          adapt=AdaptConfig(slo=SLO(max_err=1e-4), adapt_every=1, adapt=False))
        eng = ServeEngine(model, params, config=cfg)
        eng.generate_batch([_req(0, n=5, max_new=6), _req(1, n=6, max_new=6)])
        assert eng.mode_table.label() == "M8" and eng.metrics.mode_switches == 0
        errs = [e for _, e in eng.metrics.probe_errs]
        # M8 against the M24 reference: a residual near the M8 ceiling
        assert len(errs) >= 4 and 1e-4 < max(errs) < 64 * MODE_REL_ERROR[Mode.M8]
        s = eng.metrics.summary()
        assert s["mode_occupancy"] == {"M8": 1.0}

    def test_adaptive_tokens_equal_static_at_the_held_mode(self):
        """Bound to a table that never moves, the modal step computes the
        static step: same tokens."""
        _, _, model, params = make_pair("M24", n_layers=2)
        reqs = [_req(0, n=5, max_new=5), _req(1, n=8, max_new=5)]
        static = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=32))
        held = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=32,
            adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=2, adapt=False)))
        assert held.generate_batch([dataclasses.replace(r) for r in reqs]) == \
            static.generate_batch(reqs)


# ---------------------------------------------------------------------------
# against the reference's engine
# ---------------------------------------------------------------------------


def _margin_ok(jmodel, jparams, prompt, tokens, tol):
    """Per emitted token: did the reference's top-2 margin exceed ``tol`` of
    the logit scale?  (Teacher-forced replay of the reference's own stream.)"""
    seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(tokens[:-1], np.int32)])
    logits, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(seq[None])})
    rows = np.asarray(logits[0, len(prompt) - 1:])
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(rows).max()


@pytest.mark.parametrize("policy_name,kv_dtype", [("native_f32", "bfloat16"),
                                                  ("M24", "int8"), ("M8", "bfloat16")])
def test_engine_tokens_vs_reference_engine(policy_name, kv_dtype):
    jmodel, jparams, tmodel, tparams = make_pair(policy_name, kv_dtype, n_layers=2)
    ceiling = MODE_REL_ERROR[Mode.M8 if policy_name == "M8" else Mode.M24]
    tol = ceiling * FACTOR + CACHE_QUANTUM[kv_dtype] * CACHE_FLIP_SHARE
    reqs = [_req(0, n=3, max_new=6), _req(1, n=9, max_new=4), _req(2, n=6, max_new=6),
            _req(3, n=5, max_new=5)]
    jeng = JServeEngine(jmodel, jparams, batch_slots=2, max_len=32)
    want = jeng.generate_batch([JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
    teng = ServeEngine(tmodel, tparams, config=ServeConfig(batch_slots=2, max_len=32))
    got = teng.generate_batch(reqs)
    compared = 0
    margins = []
    for r in reqs:
        assert len(got[r.rid]) == len(want[r.rid])
        decided = _margin_ok(jmodel, jparams, r.prompt, want[r.rid], tol)
        margins.append(decided)
        for i, ok in enumerate(decided):
            if not ok:
                break  # past an undecided token the streams may diverge
            assert got[r.rid][i] == want[r.rid][i], (r.rid, i)
            compared += 1
    # the margin rule must leave most of the stream to compare at f32 fidelity
    if policy_name != "M8":
        assert compared >= 0.8 * sum(len(v) for v in want.values()), margins
    assert compared > 0
    js, ts = jeng.metrics.summary(), teng.metrics.summary()
    for key in ("tokens_out", "requests", "completed", "decode_steps", "occupancy"):
        assert ts[key] == js[key], key


# ---------------------------------------------------------------------------
# options that once waited for later work, and what still raises
# ---------------------------------------------------------------------------


class TestNotPortedYet:
    def test_engine_options(self, tiny):
        model, params = tiny
        base = dict(batch_slots=2, max_len=16)
        # per-tenant adaptation is ported: one table and controller a tenant
        # (tests/test_torch_tenancy.py serves it)
        eng = ServeEngine(model, params, config=ServeConfig(
            adapt=AdaptConfig(slo=SLO(max_err=0.1)),
            scheduling=SchedulingConfig(tenants=[Tenant("a")]), **base))
        assert eng.mode_table is None and set(eng.tenant_tables) == {"a", "default"}
        assert eng.tenant_ctrl["a"].slo.max_err == 0.1
        # the paged cache is ported: tests/test_torch_paged_engine.py serves it
        for spec in (None, SpecConfig()):
            eng = ServeEngine(model, params, config=ServeConfig(
                spec=spec, cache=CacheConfig(layout="paged"), **base))
            assert eng.layout.name == "paged"
        with pytest.raises(NotImplementedError, match="greedy"):
            ServeEngine(model, params, config=ServeConfig(greedy=False, **base))
        with pytest.raises(ValueError, match="not both"):
            ServeEngine(model, params, batch_slots=2, config=ServeConfig(**base))

    # the two flags the launcher once refused (the case ids are those of the
    # refusals); each now runs and prints what replaced the refusal
    @pytest.mark.parametrize("flags,expect", [
        pytest.param(["--trace-out", "t.json"], "Chrome events ->",
                     id="flags0-Queue A item 10"),
        pytest.param(["--multi-tenant", "--adapt"], "per-tenant adaptation\ntenant bulk: table",
                     id="flags1-Queue A item 9"),
    ])
    def test_launcher_flags_are_parsed_and_refused(self, flags, expect, tmp_path, monkeypatch,
                                                   capsys):
        monkeypatch.chdir(tmp_path)
        launch_serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                           "--requests", "2", "--max-new", "4", *flags])
        out = capsys.readouterr().out
        assert expect in out
        if "--trace-out" in flags:
            from repro_torch.obs import validate_chrome

            doc = json.loads((tmp_path / "t.json").read_text())
            assert validate_chrome(doc) == [] and doc["traceEvents"]
            assert "precision timeline:" in out and "-- profile --" in out

    def test_other_archs_and_families(self):
        with pytest.raises(SystemExit):
            launch_serve.main(["--arch", "no-such-arch", "--device", "cpu"])


def test_launcher_main_serves_on_the_cpu_when_asked(capsys):
    launch_serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--prompt-len", "8", "--accuracy", "2e-4", "--adapt",
                       "--adapt-every", "2", "--tune-table", "tuning/cpu.json"])
    out = capsys.readouterr().out
    assert "req 0:" in out and "req 2:" in out
    assert "decode/mlp_up" in out and "kernel library builds: 0" in out
    assert "tok/s on cpu" in out and "(table " in out


def test_launcher_main_defaults_to_the_gpu():
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--requests", "1", "--max-new", "2"]
    if torch.cuda.is_available():
        launch_serve.main(argv)
    else:
        with pytest.raises(RuntimeError, match="found no GPU"):
            launch_serve.main(argv)
