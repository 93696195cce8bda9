"""The serving engine's compiled steps (``repro_torch.serve.graphs``) on the
CPU, at the smoke size (2 layers, d_model 128, vocab 512).

On the card each compiled step is one CUDA-graph replay; here the same step
functions run eagerly on the same static buffers, which is what these tests
hold: tokens unchanged by the static inputs and state (against a plain
functional decode and, under the margin rule, the reference's engine), a
state that is written in place and never rebound, a probe that leaves it
bitwise intact, device-scalar modes bit-equal to host-int modes, and mode
or draft-shift changes that only rewrite data.  Capture and replay
themselves need the card: ``chip_smoke.py`` checks them there."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro.adapt import SLO as JSLO
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest

from repro_torch.adapt import SLO, DeviceModes, ModeTable, bind_modes
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.models.layers import pein, pmm
from repro_torch.models.lm import state_leaves
from repro_torch.plan import MODE_REL_ERROR
from repro_torch.serve import (
    AdaptConfig,
    Request,
    RequestClass,
    SchedulingConfig,
    ServeConfig,
    ServeEngine,
    Tenant,
)
from repro_torch.serve.graphs import CompiledStep, eager
from repro_torch.spec import SpecConfig

from test_torch_common import CACHE_FLIP_SHARE, CACHE_QUANTUM, FACTOR, make_pair
from test_torch_serve import _margin_ok, _req

ARMS = ("plain", "modal", "spec")
MAX_LEN = 32


@pytest.fixture(scope="module")
def pair():
    return make_pair("M24", n_layers=2)


def _config(arm: str, slots: int = 2, **kw) -> ServeConfig:
    if arm == "modal":  # bound to a table that never shifts: a fixed target
        kw["adapt"] = AdaptConfig(slo=SLO(max_err=0.5), adapt_every=2, adapt=False)
    elif arm == "spec":
        kw["spec"] = SpecConfig(k=2, draft_shift=1)
    return ServeConfig(batch_slots=slots, max_len=MAX_LEN, **kw)


def _functional_decode(model, params, req: Request, modes=None) -> list[int]:
    """Greedy tokens of one request from ``decode_step`` alone, on a fresh
    state it returns each step (the port's eager computation, no engine):
    prefill unbound, decode steps bound to the host-int ``modes``."""
    state = model.init_decode_state(1, MAX_LEN, per_slot=True)
    prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None])
    logits, state = model.decode_step(params, prompt, state)
    tokens = [int(torch.argmax(logits[0, -1]))]
    budget = min(req.max_new, MAX_LEN - len(req.prompt) + 1)
    while len(tokens) < budget:
        with bind_modes(modes) if modes else contextlib.nullcontext():
            logits, state = model.decode_step(
                params, torch.tensor([[tokens[-1]]], dtype=torch.int32), state)
        tokens.append(int(torch.argmax(logits[0, -1])))
    return tokens


def _held_modes(model) -> dict:
    return ModeTable.from_policy(model.cfg.policy).scalars()


def _requests():
    """More requests than slots (slot reuse), ragged prompts and budgets."""
    return [_req(0, n=3, max_new=6), _req(1, n=9, max_new=4), _req(2, n=6, max_new=7),
            _req(3, n=5, max_new=5), _req(4, n=4, max_new=3)]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arm", ARMS)
def test_engine_tokens_equal_the_functional_decode(pair, arm, impl):
    """Batched serving through the static inputs and state gives exactly the
    tokens of the functional decode of each request alone (speculation:
    the plain greedy tokens; the modal step: the held table's host ints)."""
    _, _, model, params = pair
    model = model.with_policy(PrecisionPolicy(default=Mode.M24, impl=impl))
    eng = ServeEngine(model, params, config=_config(arm))
    reqs = _requests()
    outs = eng.generate_batch([dataclasses.replace(r) for r in reqs])
    modes = _held_modes(model) if arm == "modal" else None
    for r in reqs:
        assert outs[r.rid] == _functional_decode(model, params, r, modes), r.rid
    assert eng.graph_capture_count == 0  # the CPU runs the steps eagerly
    if arm == "spec":
        assert eng.metrics.spec_rounds > 0
    if arm == "modal":
        assert eng.controller.history  # the probe ran between the steps


def test_modal_engine_tokens_vs_reference_engine(pair):
    """The modal step (device-scalar modes) against the reference's adaptive
    engine, under the margin rule of ``test_engine_tokens_vs_reference_engine``
    (that test and ``test_spec_tokens_vs_reference_spec_engine`` hold the
    plain and speculative arms, which run through the same compiled steps)."""
    jmodel, jparams, model, params = pair
    tol = MODE_REL_ERROR[Mode.M24] * FACTOR + CACHE_QUANTUM["bfloat16"] * CACHE_FLIP_SHARE
    reqs = _requests()
    jeng = JServeEngine(jmodel, jparams, batch_slots=2, max_len=MAX_LEN,
                        slo=JSLO(max_err=0.5), adapt_every=2, adapt=False)
    want = jeng.generate_batch([JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
    got = ServeEngine(model, params, config=_config("modal")).generate_batch(reqs)
    compared = 0
    for r in reqs:
        assert len(got[r.rid]) == len(want[r.rid])
        for i, ok in enumerate(_margin_ok(jmodel, jparams, r.prompt, want[r.rid], tol)):
            if not ok:
                break  # past an undecided token the streams may diverge
            assert got[r.rid][i] == want[r.rid][i], (r.rid, i)
            compared += 1
    assert compared >= 0.8 * sum(len(v) for v in want.values())


@pytest.mark.parametrize("arm", ["plain", "spec"])  # tenants with slo= raise
def test_park_resume_and_slot_reuse_write_the_static_state(pair, arm):
    """Preemption parks a row and scatters it back, prefill scatters rows
    in and finished rows are freed — each into the static state's own
    tensors, which are never rebound (a captured step holds their
    addresses); the preempted stream is the functional decode's."""
    _, _, model, params = pair
    tenants = [Tenant("interactive", priority=0), Tenant("bulk", priority=2)]
    classes = [RequestClass("chat", slo_steps=8), RequestClass("batch")]
    eng = ServeEngine(model, params, config=_config(
        arm, slots=1, scheduling=SchedulingConfig(tenants=tenants, classes=classes,
                                                  min_quantum=2)))
    ptrs = [x.data_ptr() for x in state_leaves(eng.state)]
    state = eng.state
    bulk = _req(0, n=6, max_new=20, tenant="bulk", rclass="batch")
    chat = _req(1, n=4, max_new=3, tenant="interactive", rclass="chat")
    eng.submit(bulk)
    for _ in range(3):
        eng.step()
    eng.submit(chat)  # more urgent: parks the bulk request's state row
    done = eng.drain()
    assert eng.scheduler.preemptions == 1 and not eng._parked
    assert eng.state is state and [x.data_ptr() for x in state_leaves(eng.state)] == ptrs
    for r in (bulk, chat):
        assert done[r.rid] == _functional_decode(model, params, r), r.rid


def test_probe_leaves_the_state_bitwise_intact(pair):
    _, _, model, params = pair
    eng = ServeEngine(model, params, config=_config("modal"))
    for r in _requests()[:2]:
        eng.submit(dataclasses.replace(r, max_new=12))
    for _ in range(3):
        eng.step()
    before = [x.clone() for x in state_leaves(eng.state)]
    table = eng.mode_table
    errs = eng._probe_fn(table.scalars(), table.scalars_shifted(2), table.scalars_shifted(-1))
    eng._adapt_tick()
    assert all(torch.equal(x, y) for x, y in zip(state_leaves(eng.state), before))
    # the current table is M24 = the reference: no residual; one down is M16
    assert errs[0] == 0.0 and errs[1] > 0.0


def _site_operands(rng, site: str):
    """(eq or None for pmm, a, b) at the smoke size's shapes for one site."""
    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if site == "pmm":
        return None, r(2, 1, 64), r(64, 48)
    if site == "attn_qk":  # (B, Sq, Hkv, G, hd) x (B, C, Hkv, hd)
        return "bqhgd,bkhd->bhgqk", r(2, 1, 2, 2, 16), r(2, 12, 2, 16)
    if site == "attn_av":  # softmax weights x values
        return "bhgqk,bkhd->bhgqd", torch.softmax(r(2, 2, 2, 1, 12), -1), r(2, 12, 2, 16)
    return "bsd,vd->bsv", r(2, 1, 64), r(96, 64)  # tied logits


@pytest.mark.parametrize("rounding", ["rne", "grte"])
@pytest.mark.parametrize("impl", ["xla", "tile"])
@pytest.mark.parametrize("site", ["pmm", "attn_qk", "attn_av", "logits"])
def test_device_scalar_modes_equal_host_int_modes_bitwise(site, impl, rounding):
    """A site bound to a device int32 scalar (a ``DeviceModes`` view: the
    engine's compiled steps) computes exactly what the same site bound to
    the host int computes, at every f32 mode: ``pmm`` through the mode-map
    kernel's plain version (``tile``) or the limb algebra (``xla``), and
    ``pein`` (attention scores and values, logits) through one shared set of
    limb products selected on the device."""
    eq, a, b = _site_operands(np.random.default_rng(5), site)
    policy = PrecisionPolicy(default=Mode.M8, impl=impl, rounding=rounding)
    op = "mlp_up" if site == "pmm" else site
    view = DeviceModes([op], "cpu")

    def run(modes):
        with bind_modes(modes):
            return pmm(a, b, op, policy) if eq is None else pein(eq, a, b, op, policy)

    results = []
    for mode in (Mode.M8, Mode.M16, Mode.M24):
        view.write({op: int(mode)})
        host, dev = run({op: int(mode)}), run(view.scalars)
        assert torch.equal(host, dev), (site, impl, mode)
        results.append(host)
    # the three modes differ: the selection is not stuck on one branch
    assert not torch.equal(results[0], results[1]) and not torch.equal(results[1], results[2])


def test_mode_and_draft_shifts_allocate_no_new_step_object(pair):
    """Mode-table shifts and draft-shift changes rewrite the compiled steps'
    device views; the step objects, their views and the capture count stay
    (one object per compiled step, built at construction)."""
    _, _, model, params = pair
    rng = np.random.default_rng(9)
    eng = ServeEngine(model, params, config=ServeConfig(
        batch_slots=2, max_len=MAX_LEN, spec=SpecConfig(k=2, draft_shift=1, adapt=False),
        adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1, adapt=False)))
    objects = [eng._round_graph, eng._probe_graph, eng._draft_modes, eng._verify_modes,
               eng._probe_modes, eng._tokens, eng._active_dev, eng.state]
    assert eng._step_graph is None  # speculation replaces the decode step
    eng.generate_batch([Request(rng.integers(0, 512, 5).astype(np.int32), 6, rid=0)])
    eng._draft_shift = 2  # a run-time shift change
    eng.mode_table.shift_all(-1, tag="test")  # a mode-table change
    eng.generate_batch([Request(rng.integers(0, 512, 6).astype(np.int32), 6, rid=1)])
    after = [eng._round_graph, eng._probe_graph, eng._draft_modes, eng._verify_modes,
             eng._probe_modes, eng._tokens, eng._active_dev, eng.state]
    assert all(x is y for x, y in zip(objects, after))
    assert eng.graph_capture_count == 0 and eng.kernel_build_count == 0
    table, view = eng._spec_table, eng._draft_modes
    want = table.scalars_shifted(-eng.draft_shift)
    assert view.scalars and {s: int(v) for s, v in view.scalars.items()} == want
    assert {s: int(v) for s, v in eng._verify_modes.scalars.items()} == table.scalars()


def test_compiled_step_runs_its_function_eagerly_off_the_card():
    """On the CPU, and on any device inside ``eager()``, a compiled step is
    its function: called every time, nothing captured."""
    calls = []

    def fn():
        calls.append(1)
        return torch.full((2,), len(calls))

    for device in ("cpu", "cuda"):
        step = CompiledStep(fn, device, name="t")
        if device == "cuda":
            with eager(), eager():
                assert step().tolist() == [len(calls)] * 2
            continue
        assert step().tolist() == [1, 1] and step().tolist() == [2, 2]
        assert (step.captures, step.replays, step.graph) == (0, 0, None)
    assert len(calls) == 3
