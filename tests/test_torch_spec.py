"""Self-speculative decoding in the port (repro_torch.spec), on the CPU at the
smoke size (2 layers, d_model 128, vocab 512): the speculative engine emits
exactly the plain engine's tokens (mid-flight joins, int8 KV cache, heavy
rejection, modal verify under ``slo=``), bursts stay inside each request's
budget, the pre-round state survives a round untouched, draft-shift moves
build nothing, the acceptance controller decides as the reference's does,
and the port's speculative tokens agree with the reference's speculative
engine under the decided-token rule of ``test_torch_serve``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.adapt.workload import conditioned_model
from repro.core.precision import Mode as JMode
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest
from repro.spec import AcceptanceController as JAcceptanceController
from repro.spec import SpecConfig as JSpecConfig

from repro_torch.adapt import SLO
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.kernels import build
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.lm import map_state
from repro_torch.plan import MODE_REL_ERROR
from repro_torch.serve import (
    AdaptConfig,
    Request,
    SchedulingConfig,
    ServeConfig,
    ServeEngine,
    Tenant,
)
from repro_torch.serve.paged import compute_axes
from repro_torch.spec import AcceptanceController, SpecConfig
from repro_torch.spec.rollout import rollback, snapshot

from test_torch_common import CACHE_FLIP_SHARE, CACHE_QUANTUM, FACTOR, make_pair
from test_torch_serve import _margin_ok, _req


@pytest.fixture(scope="module")
def pair():
    return make_pair("native_f32", n_layers=2)


@pytest.fixture(scope="module")
def tiny(pair):
    return pair[2], pair[3]


def _ragged(n, rng, vocab=512, max_prompt=10, max_new=9):
    return [Request(rng.integers(0, vocab, int(rng.integers(3, max_prompt))).astype(np.int32),
                    int(rng.integers(3, max_new)), rid=i) for i in range(n)]


def _drain_with_join(eng, reqs, join_after=2):
    """Submit some requests, step, submit the rest mid-flight, drain."""
    for r in reqs[:3]:
        eng.submit(dataclasses.replace(r))
    for _ in range(join_after):
        eng.step()
    for r in reqs[3:]:
        eng.submit(dataclasses.replace(r))
    return eng.drain()


def _leaves(state):
    out = [state.position]
    for layers in state.caches.values():
        for c in layers:
            out += [x for x in (c.k, c.v, c.k_scale, c.v_scale, c.pos, c.length)
                    if x is not None]
    return out


def _pair_of_engines(model, params, spec, slots=2, max_len=32, **kw):
    base = ServeEngine(model, params, config=ServeConfig(batch_slots=slots, max_len=max_len, **kw))
    eng = ServeEngine(model, params, config=ServeConfig(
        batch_slots=slots, max_len=max_len, spec=spec, **kw))
    return base, eng


class TestEquivalence:
    """drain() must be token-for-token identical to the plain engine."""

    @pytest.mark.parametrize("k", [1, 3])
    def test_mid_flight_join(self, tiny, k):
        model, params = tiny
        reqs = _ragged(5, np.random.default_rng(1))
        base, spec = _pair_of_engines(model, params, SpecConfig(k=k, draft_shift=1))
        assert _drain_with_join(base, reqs) == _drain_with_join(spec, reqs)
        assert spec.metrics.acceptance_rate is not None

    def test_int8_kv_cache(self):
        _, _, model, params = make_pair("native_f32", "int8", n_layers=2)
        reqs = _ragged(4, np.random.default_rng(2))
        base, spec = _pair_of_engines(model, params, SpecConfig(k=2, draft_shift=1))
        assert _drain_with_join(base, reqs) == _drain_with_join(spec, reqs)

    def test_exact_under_heavy_rejection(self):
        # the reference's conditioned workload (hot requests) converted to
        # the port: the M8 draft disagrees with the M24 verify on about a
        # quarter of the drafts, and every rejection must roll the slot back
        # to exactly the plain engine's state
        wl = conditioned_model(mode=JMode.M24, width=128)
        cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), n_layers=1,
                                  rope_theta=wl.model.cfg.rope_theta)
        model = build_model(cfg.with_policy(PrecisionPolicy(default=Mode.M24)), device="cpu")
        params = params_from_jax(jax.tree.map(np.asarray, wl.params), device="cpu")
        reqs = [Request(np.asarray(r.prompt, np.int32), r.max_new, rid=i) for i, r in
                enumerate(wl.requests(8, hot=set(range(8)), rng=np.random.default_rng(0),
                                      max_new=10))]
        base, spec = _pair_of_engines(model, params, SpecConfig(k=3, draft_shift=2, adapt=False),
                                      slots=3, max_len=24)
        for r in reqs:
            base.submit(dataclasses.replace(r))
            spec.submit(dataclasses.replace(r))
        assert base.drain() == spec.drain()
        m = spec.metrics
        assert m.spec_drafted - m.spec_accepted > 0, "no rejection exercised"
        assert m.verify_steps_per_token < 1.0

    def test_rollback_is_the_accepted_prefix_of_plain_steps_across_a_ring_wrap(self, tiny):
        # a cache two rows from full: the four verify writes wrap onto rows
        # 0-1, which hold live tokens; each slot must come back bit for bit
        # as the plain step leaves it after its accepted prefix + correction
        model, params = tiny
        rng = np.random.default_rng(13)
        prompts = torch.as_tensor(rng.integers(0, 512, (3, 8)).astype(np.int32))
        inputs = torch.as_tensor(rng.integers(0, 512, (3, 4)).astype(np.int32))
        _, state0 = model.decode_step(params, prompts,
                                      model.init_decode_state(3, 10, per_slot=True))
        plain, st = [state0], state0
        for i in range(4):
            _, st = model.decode_step(params, inputs[:, i:i + 1], st)
            plain.append(st)
        snaps = [snapshot(x) for x in plain[1:]]
        n_acc = torch.tensor([0, 2, 3], dtype=torch.int32)
        active = torch.tensor([True, True, False])
        axes = compute_axes(model.init_decode_state(1, 1, per_slot=True))
        rolled = rollback(axes, state0, plain[4], snaps, n_acc, active)
        assert bool((plain[4].caches["seg0_dense"][0].pos[:, :2] >= 10).all())  # wrapped
        for slot, want in ((0, plain[1]), (1, plain[3]), (2, state0)):
            for x, y in zip(_leaves(rolled), _leaves(want)):
                assert torch.equal(x[slot], y[slot]), slot

    def test_slo_modal_verify_matches_modal_baseline(self, tiny):
        model, params = tiny
        reqs = _ragged(4, np.random.default_rng(4))
        held = AdaptConfig(slo=SLO(max_err=0.5), adapt=False)
        base, spec = _pair_of_engines(model, params, SpecConfig(k=2, draft_shift=1), adapt=held)
        assert spec._spec_table is spec.mode_table  # one table, SLO-owned
        assert _drain_with_join(base, reqs) == _drain_with_join(spec, reqs)

    def test_planned_phases(self, tiny):
        model, params = tiny
        reqs = _ragged(4, np.random.default_rng(5))
        base, spec = _pair_of_engines(model, params, SpecConfig(k=2, draft_shift=1),
                                      accuracy=2**-4)
        assert _drain_with_join(base, reqs) == _drain_with_join(spec, reqs)


class TestMechanics:
    def test_burst_clamped_to_budget(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(6)
        reqs = [Request(rng.integers(0, 512, 5).astype(np.int32), m, rid=i)
                for i, m in enumerate([1, 2, 7])]
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=3, max_len=32, spec=SpecConfig(k=4, draft_shift=1)))
        outs = eng.generate_batch(reqs)
        assert [len(outs[i]) for i in range(3)] == [1, 2, 7]
        s = eng.metrics.summary()
        assert s["spec_accepted"] <= s["spec_emitted"]

    def test_metrics_and_describe(self, tiny):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=32, spec=SpecConfig(k=3, draft_shift=1)))
        eng.generate_batch(_ragged(4, np.random.default_rng(7)))
        s = eng.metrics.summary()
        assert s["spec_rounds"] > 0
        assert s["spec_drafted"] == s["spec_accepted"] + s["spec_rejected"]
        assert 0.0 <= s["acceptance_rate"] <= 1.0
        assert 0.0 < s["verify_steps_per_token"] <= 1.0
        assert "acceptance" in eng.describe_speculation()
        assert "k=3" in eng.describe()["speculation"]
        assert "spec" in eng.metrics.format_summary()
        plain = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=32))
        assert plain.describe_speculation() == "speculation off (no speculate=)"
        assert plain.spec_compile_count is None

    def test_pre_round_state_is_untouched_by_the_round(self, tiny):
        model, params = tiny
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=32, spec=SpecConfig(k=3, draft_shift=2, adapt=False)))
        for r in _ragged(2, np.random.default_rng(8), max_new=20):
            eng.submit(r)
        eng.step()  # prefill both, one round
        before = eng.state
        saved = map_state(lambda x: x.clone(), before)
        tokens, active = eng._device_inputs()
        drafts, greedy, n_acc, after = eng._spec_round(
            eng.params, tokens, before, active,
            eng._spec_table.scalars_shifted(-eng.draft_shift), eng._spec_table.scalars())
        assert all(torch.equal(x, y) for x, y in zip(_leaves(before), _leaves(saved))), \
            "the round wrote into its input state"
        assert after is not before
        assert drafts.shape == (3, 2) and greedy.shape == (4, 2) and n_acc.shape == (2,)

    def test_draft_shift_moves_build_nothing(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(9)
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=32, spec=SpecConfig(k=2, draft_shift=1, adapt=False)))
        eng.generate_batch(_ragged(3, rng))
        eng._draft_shift = 2  # a run-time shift change
        eng.generate_batch([dataclasses.replace(r, rid=10 + r.rid) for r in _ragged(3, rng)])
        eng._spec_table.shift_all(-1, tag="test")  # a mode-table change
        eng.generate_batch([Request(rng.integers(0, 512, 5).astype(np.int32), 4, rid=99)])
        assert eng.spec_compile_count == eng.kernel_build_count == build.BUILD_COUNT == 0
        assert build.launch_counts() == {name: 0 for name in build.LAUNCHES}

    def test_latency_signal_normalized_per_token(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(10)
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=48,
            adapt=AdaptConfig(slo=SLO(max_err=0.5, target_ms=1e9), adapt=False, adapt_every=1),
            spec=SpecConfig(k=3, draft_shift=1, adapt=False)))
        eng.generate_batch([Request(rng.integers(0, 512, 6).astype(np.int32), 12, rid=i)
                            for i in range(2)])
        assert eng._last_step_tokens > 1.0  # bursts actually happened
        eng._active[0] = True  # re-arm one row for a manual probe tick
        eng._last_step_ms, eng._last_step_tokens = 100.0, 4.0
        eng._adapt_tick()
        assert eng.controller.history[-1].step_ms == pytest.approx(25.0)

    def test_refusals(self, tiny):
        model, params = tiny
        base = dict(batch_slots=2, max_len=16)
        with pytest.raises(TypeError, match="SpecConfig"):
            ServeEngine(model, params, config=ServeConfig(spec={"k": 2}, **base))
        # per-tenant tables would need per-slot modes inside the round: the
        # reference's own refusal
        with pytest.raises(NotImplementedError, match="per-tenant"):
            ServeEngine(model, params, config=ServeConfig(
                spec=SpecConfig(), adapt=AdaptConfig(slo=SLO(max_err=0.1)),
                scheduling=SchedulingConfig(tenants=[Tenant("a")]), **base))
        with pytest.raises(NotImplementedError, match="greedy"):
            ServeEngine(model, params, config=ServeConfig(
                spec=SpecConfig(), greedy=False, **base))
        with pytest.raises(ValueError, match="k must be >= 1"):
            SpecConfig(k=0)
        with pytest.raises(ValueError, match="draft_shift must be >= 1"):
            SpecConfig(draft_shift=0)

    def test_launcher_speculates_on_the_cpu(self, capsys):
        launch_serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2", "--max-new", "5",
                           "--prompt-len", "8", "--policy", "paper_baseline",
                           "--speculate", "--draft-k", "2", "--draft-shift", "1"])
        out = capsys.readouterr().out
        assert "k=2 draft_shift=" in out and "acceptance" in out
        assert "kernel library builds: 0" in out and "req 2:" in out


class TestAcceptanceController:
    @pytest.mark.parametrize("cfg", [
        dict(draft_shift=2, max_reject=0.4, cooldown=0),
        dict(draft_shift=1, max_reject=0.4, down_factor=0.25, cooldown=0),
        dict(draft_shift=2, max_reject=0.3, cooldown=3),
    ])
    def test_decisions_equal_the_reference(self, cfg):
        rates = np.random.default_rng(11).random(40) ** 2
        ours = AcceptanceController(SpecConfig(**cfg), ladder=2)
        theirs = JAcceptanceController(JSpecConfig(**cfg), ladder=2)
        trace = []
        for i, r in enumerate(rates):
            d = ours.observe(i, float(r))
            assert d == theirs.observe(i, float(r)) and ours.shift == theirs.shift
            trace.append(d)
        assert {-1, 1} <= set(trace)
        assert (ours.shallower_moves, ours.deeper_moves) == (
            theirs.shallower_moves, theirs.deeper_moves)

    def test_engine_adapts_shift_from_acceptance(self, tiny):
        model, params = tiny
        rng = np.random.default_rng(8)
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=2, max_len=48, spec=SpecConfig(k=2, draft_shift=1, every=2, cooldown=0)))
        eng.generate_batch([Request(rng.integers(0, 512, 6).astype(np.int32), 20, rid=i)
                            for i in range(4)])
        assert eng.metrics.draft_shift_timeline
        assert eng.metrics.draft_shift_timeline[0][1] == 2  # first move: deeper


@pytest.mark.parametrize("policy_name,kv_dtype", [("native_f32", "bfloat16"), ("M24", "int8")])
def test_spec_tokens_vs_reference_spec_engine(policy_name, kv_dtype):
    jmodel, jparams, tmodel, tparams = make_pair(policy_name, kv_dtype, n_layers=2)
    tol = MODE_REL_ERROR[Mode.M24] * FACTOR + CACHE_QUANTUM[kv_dtype] * CACHE_FLIP_SHARE
    reqs = [_req(0, n=3, max_new=6), _req(1, n=9, max_new=4), _req(2, n=6, max_new=6),
            _req(3, n=5, max_new=5)]
    jeng = JServeEngine(jmodel, jparams, batch_slots=2, max_len=32,
                        speculate=JSpecConfig(k=3, draft_shift=1))
    want = jeng.generate_batch([JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
    teng = ServeEngine(tmodel, tparams, config=ServeConfig(
        batch_slots=2, max_len=32, spec=SpecConfig(k=3, draft_shift=1)))
    got = teng.generate_batch(reqs)
    compared = 0
    for r in reqs:
        assert len(got[r.rid]) == len(want[r.rid])
        for i, ok in enumerate(_margin_ok(jmodel, jparams, r.prompt, want[r.rid], tol)):
            if not ok:
                break  # past an undecided token the streams may diverge
            assert got[r.rid][i] == want[r.rid][i], (r.rid, i)
            compared += 1
    assert compared >= 0.8 * sum(len(v) for v in want.values())
    assert teng.metrics.spec_rounds > 0 and jeng.metrics.spec_rounds > 0
