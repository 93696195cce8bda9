"""Port vs reference, the conditioned hot/cold workload (repro_torch.adapt.
workload) and the closed adaptation loop it drives, on the CPU at the
reference's own size (one layer, d_model 128).

The doctoring is NumPy on the parameters' values, so given the reference's
undoctored init (through ``convert.params_from_jax``) the port's
``condition_params`` must give the reference's doctored parameters bit for
bit.  Probe residuals of the two engines on the same parameters are held
to ``residual_tol``; where every residual lies farther than that from the
controller's thresholds, the two mode timelines must be equal."""
import dataclasses

import numpy as np
import pytest
import jax

from repro.adapt import SLO as JSLO
from repro.adapt.workload import conditioned_model as j_conditioned_model
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest

from repro_torch.adapt import SLO
from repro_torch.adapt.workload import (
    ConditionedWorkload,
    condition_params,
    conditioned_config,
    conditioned_model,
)
from repro_torch.convert import params_from_jax
from repro_torch.core.precision import Mode
from repro_torch.models import build_model
from repro_torch.serve import AdaptConfig, Request, ServeConfig, ServeEngine

import test_torch_common  # noqa: F401  (one PyTorch thread per process)

#: |port - reference| allowed for a probe residual ``r`` (already relative
#: to the logits' scale) on the same parameters and requests:
#: RESIDUAL_ATOL + RESIDUAL_RTOL * r.  The K/V cache is bf16, and a value
#: the two frameworks computed an ulp apart can round to the neighbouring
#: code; the hot tokens' payload cancels, so such a code moves a residual by
#: up to one cache quantum of itself (2^-8).  Measured: 8.0e-7 at M8 before
#: any shift, 2.8e-4 on an M8 one-down residual of 0.16 after the run sat
#: at M16, 2.2e-5 at M16 (residuals 1e-4-4e-3).
RESIDUAL_ATOL = 1e-4
RESIDUAL_RTOL = 2.0**-8


def residual_tol(r: float) -> float:
    return RESIDUAL_ATOL + RESIDUAL_RTOL * abs(r)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def ref_workload():
    return j_conditioned_model()


@pytest.fixture(scope="module")
def port_on_ref_params(ref_workload):
    """The port's workload on the reference's doctored parameters."""
    jwl = ref_workload
    cfg = conditioned_config()
    params = params_from_jax(jax.tree.map(np.asarray, jwl.params), device="cpu")
    return ConditionedWorkload(cfg=cfg, model=build_model(cfg, device="cpu"),
                               params=params, hot_ids=jwl.hot_ids,
                               safe_vocab=jwl.safe_vocab)


# ---------------------------------------------------------------------------
# the doctoring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"width": 256},
                                {"payload_gain": 10.0, "score_offset": 2.0, "n_hot": 5,
                                 "seed": 3, "value_gain": 2.0}],
                         ids=["default", "width256", "knobs"])
def test_doctored_params_equal_the_reference_bit_for_bit(kw):
    width = kw.get("width")
    knobs = {k: v for k, v in kw.items() if k != "width"}
    jwl = j_conditioned_model(width=width, **knobs)
    base = jwl.model.init(jax.random.key(0))  # the reference's undoctored init
    params = params_from_jax(jax.tree.map(np.asarray, base), device="cpu")
    cfg = conditioned_config(width=width)
    hot = condition_params(cfg, params, **knobs)
    assert hot == jwl.hot_ids
    want = dict(_leaves(jax.tree.map(np.asarray, jwl.params)))
    got = dict(_leaves(params))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, path
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), path


@pytest.mark.parametrize("width", [None, 384])
def test_config_equals_the_reference(width):
    jcfg = j_conditioned_model(width=width).cfg
    cfg = conditioned_config(width=width)
    for f in ("n_layers", "d_model", "d_ff", "n_heads", "n_kv_heads", "head_dim",
              "vocab", "rope_theta", "qkv_bias", "tie_embeddings", "kv_cache_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.policy.default == Mode.M8 and int(jcfg.policy.default) == int(Mode.M8)


def test_prompts_and_requests_equal_the_reference(ref_workload, port_on_ref_params):
    jwl = ref_workload
    wl = conditioned_model(device="cpu")
    assert wl.hot_ids == jwl.hot_ids and wl.safe_vocab == jwl.safe_vocab
    for make in ("hot_prompt", "normal_prompt"):
        for length in (3, 6, 11):
            got = getattr(wl, make)(np.random.default_rng(length), length)
            want = getattr(jwl, make)(np.random.default_rng(length), length)
            assert got.dtype == want.dtype and np.array_equal(got, want), (make, length)
    got = wl.requests(5, {0, 3}, np.random.default_rng(9), prompt_len=7, max_new=4)
    want = jwl.requests(5, {0, 3}, np.random.default_rng(9), prompt_len=7, max_new=4)
    assert [(r.rid, r.max_new, r.prompt.tolist()) for r in got] == \
        [(r.rid, r.max_new, r.prompt.tolist()) for r in want]
    assert all(isinstance(r, Request) for r in got)


def test_port_model_is_doctored_on_its_own_init():
    wl = conditioned_model(device="cpu")
    attn = wl.params["layers"]["seg0_dense"]["attn"]
    assert wl.cfg.n_layers == 1 and wl.cfg.rope_theta == 1e9
    assert not attn["wq"]["w"].any()  # constant queries
    emb = wl.params["embed"]["w"].double()
    hot = emb[list(wl.hot_ids)]
    # hot embeddings are unit vectors; ordinary ones keep the init's scale
    assert np.allclose(hot.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert float(emb[: wl.safe_vocab].norm(dim=-1).max()) < 0.5
    # the port's own init differs from the reference's (another generator),
    # the doctoring does not: the same hot-token directions
    base = build_model(wl.cfg, device="cpu").init(0)
    same = condition_params(wl.cfg, base)
    assert same == wl.hot_ids
    assert np.array_equal(base["embed"]["w"][list(wl.hot_ids)].numpy(), hot.float().numpy())


def test_conditioned_model_needs_the_gpu_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no GPU"):
        conditioned_model()


# ---------------------------------------------------------------------------
# the loop: residuals and timelines against the reference engine
# ---------------------------------------------------------------------------


def _three_phases(eng, wl, request_cls):
    """Tame traffic, a hot batch (rids 100-103, three hot), tame again."""
    rng = np.random.default_rng(0)
    for base, hot, max_new in ((0, set(), 8), (100, {0, 1, 2}, 12), (200, set(), 8)):
        for r in wl.requests(4, hot=hot, rng=rng, max_new=max_new):
            eng.submit(request_cls(r.prompt, r.max_new, rid=r.rid + base))
        eng.drain()
    return eng


def _ref_run(jwl, adapt: bool):
    return _three_phases(JServeEngine(
        jwl.model, jwl.params, batch_slots=4, max_len=48,
        slo=JSLO(max_err=0.5), adapt_every=1, adapt=adapt), jwl, JRequest)


def _port_run(wl, adapt: bool):
    return _three_phases(ServeEngine(wl.model, wl.params, config=ServeConfig(
        batch_slots=4, max_len=48,
        adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1, adapt=adapt))), wl, Request)


@pytest.fixture(scope="module")
def monitor_runs(ref_workload, port_on_ref_params):
    return _ref_run(ref_workload, False), _port_run(port_on_ref_params, False)


@pytest.fixture(scope="module")
def adaptive_runs(ref_workload, port_on_ref_params):
    return _ref_run(ref_workload, True), _port_run(port_on_ref_params, True)


def _near_threshold(obs, slo) -> bool:
    up, down = slo.max_err, slo.max_err * slo.down_factor
    return (abs(obs.err - up) < residual_tol(up)
            or abs(obs.err_down - down) < residual_tol(down))


@pytest.mark.parametrize("runs", ["monitor_runs", "adaptive_runs"])
def test_probe_residuals_agree_with_the_reference(runs, request):
    jeng, teng = request.getfixturevalue(runs)
    want = jeng.controller.history
    got = teng.controller.history
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g.step == w.step
        assert abs(g.err - w.err) <= residual_tol(w.err), (g.step, g.err, w.err)
        assert abs(g.err_down - w.err_down) <= residual_tol(w.err_down), \
            (g.step, g.err_down, w.err_down)
    # the hot batch really crosses the SLO and the tame traffic does not
    errs = [o.err for o in want]
    assert max(errs) > 0.5 > errs[0]


def test_monitor_mode_holds_and_sees_the_violation(monitor_runs):
    jeng, teng = monitor_runs
    assert teng.mode_table.label() == "M8" and teng.metrics.mode_switches == 0
    assert max(e for _, e in teng.metrics.probe_errs) > 0.5
    assert teng.metrics.mode_timeline == jeng.metrics.mode_timeline


def test_mode_timeline_equals_the_reference_where_residuals_decide(adaptive_runs):
    jeng, teng = adaptive_runs
    slo = teng.controller.slo
    want, got = jeng.controller.history, teng.controller.history
    decided = 0
    for g, w in zip(got, want):
        if _near_threshold(w, slo) or _near_threshold(g, slo):
            break  # past an undecided observation the two runs may differ
        assert g.decision == w.decision, g.step
        decided += 1
    assert decided == len(want), "a residual lay within the tolerance of a threshold"
    assert teng.metrics.mode_timeline == jeng.metrics.mode_timeline
    assert [(t, m) for t, m in teng.mode_table.history] == \
        [(t, {s: Mode(int(v)) for s, v in m.items()}) for t, m in jeng.mode_table.history]


def test_hot_batch_shifts_up_then_back_down():
    """The reference's closed-loop acceptance (tests/test_adapt.py::
    TestClosedLoop) on the port's own doctored model."""
    wl = conditioned_model(device="cpu")
    eng = ServeEngine(wl.model, wl.params, config=ServeConfig(
        batch_slots=4, max_len=48, adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1)))
    assert eng.mode_table.label() == "M8"  # policy pick = initial condition
    rng = np.random.default_rng(0)

    def submit(reqs, base):
        for r in reqs:
            eng.submit(dataclasses.replace(r, rid=r.rid + base))

    # phase 1: tame traffic holds the cheap mode
    submit(wl.requests(4, hot=set(), rng=rng, max_new=8), 0)
    eng.drain()
    assert eng.mode_table.label() == "M8"
    up_before = eng.controller.up_shifts
    # phase 2: ill-conditioned batch -> up within the cooldown window
    submit(wl.requests(4, hot={0, 1, 2}, rng=rng, max_new=12), 100)
    steps_at_join = eng.metrics.decode_steps
    while eng.scheduler.has_work():
        eng.step()
        if eng.controller.up_shifts > up_before:
            break
    window = eng.metrics.decode_steps - steps_at_join
    assert eng.controller.up_shifts == up_before + 1
    assert window <= eng.controller.cooldown + 2 * eng.adapt_every
    assert int(Mode[eng.mode_table.label()]) > int(Mode.M8)
    eng.drain()
    # phase 3: tame traffic again -> back down to the cheap mode
    submit(wl.requests(4, hot=set(), rng=rng, max_new=8), 200)
    eng.drain()
    assert eng.mode_table.label() == "M8"
    assert eng.controller.down_shifts >= 1
    assert eng.metrics.mode_switches >= 2
    labels = [lab for _, lab in eng.metrics.mode_timeline]
    assert labels[0] == "M8" and labels[-1] == "M8" and len(labels) >= 3
    # nothing built or captured across the mode values
    assert eng.decode_compile_count == eng.kernel_build_count == 0
    assert eng.graph_capture_count == 0


def test_occupancy_and_probe_stats_in_summary():
    wl = conditioned_model(device="cpu")
    rng = np.random.default_rng(2)
    eng = ServeEngine(wl.model, wl.params, config=ServeConfig(
        batch_slots=2, max_len=48, adapt=AdaptConfig(slo=SLO(max_err=0.5), adapt_every=2)))
    for r in wl.requests(2, hot={0}, rng=rng, max_new=10):
        eng.submit(r)
    eng.drain()
    s = eng.metrics.summary()
    assert abs(sum(s["mode_occupancy"].values()) - 1.0) < 1e-6
    assert s["probe_err_max"] >= s["probe_err_mean"] > 0.0
    assert "modes" in eng.metrics.format_summary()
