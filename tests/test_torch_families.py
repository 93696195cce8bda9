"""Port vs reference, the recurrent families as whole models and as served
models: ``mamba2-2.7b`` (``ssm``: Mamba-2 blocks) and ``recurrentgemma-9b``
(``hybrid``: (rec, rec, attn_local) supergroups), on the CPU at their smoke
sizes (4 and 6 layers, d_model 128, vocab 512) or cut shallower where a
cell of the reference's own tests says so.

* the parameter trees convert (``convert.params_from_jax``) and the port's
  ``init`` makes the reference's layout;
* prefill and teacher-forced decode logits against the reference's, under
  three policies;
* engine tokens against the reference's engine, under the margin rule of
  ``test_torch_serve``;
* the reference's serving cells for these families, re-run on the port:
  speculation with a mid-flight join (``tests/test_spec.py:55``), the ring
  rollback of the sliding window (``:96``), paged == dense
  (``tests/test_paged.py:243``), copy-on-write on the local-window wrap
  (``:294``), exact tokens under preemption (``tests/test_tenancy.py:86``)
  and the hybrid's paged trace (``tests/test_obs.py:304``);
* the recurrent state's park / resume and rollback, bit for bit, and the
  compiled steps' repair: a dropped engine dies without a cycle collection.

Tolerance of the logits: the policy's ceiling (``MODE_REL_ERROR``) times
``FACTOR`` per four layers the error passes through (the smoke hybrid has
six), and for the hybrid's decode steps, which read a bf16 KV cache the port
filled itself, a share ``CACHE_FLIP_SHARE`` of one cache quantum on top (as
``test_torch_model`` states for the dense family).  The SSM's recurrent
states are f32 and add nothing."""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scheduler_model import check_replay, check_slot_accounting
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest

from repro_torch.adapt import SLO
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import NATIVE_F32
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.griffin import RGLRUState
from repro_torch.models.layers import KVCache, PagedKVCache
from repro_torch.models.lm import state_leaves
from repro_torch.models.ssm import SSMState
from repro_torch.obs import TraceConfig
from repro_torch.plan import MODE_REL_ERROR
from repro_torch.serve import (
    AdaptConfig,
    CacheConfig,
    Request,
    RequestClass,
    ServeConfig,
    ServeEngine,
    Tenant,
    class_requests,
)
from repro_torch.serve.paged import DenseLayout, PagedLayout
from repro_torch.spec import SpecConfig
from repro_torch.spec.rollout import rollback, snapshot

from test_torch_common import (
    CACHE_FLIP_SHARE,
    CACHE_QUANTUM,
    FACTOR,
    POLICY_CASES,
    _gap,
    make_pair,
)
from test_torch_serve import _margin_ok

FAMILIES = ["mamba2-2.7b", "recurrentgemma-9b"]


def _tiny(arch, n_layers=2, seed=0, **over):
    """The port's model at the smoke size under native f32, ``n_layers``
    deep, with the port's own seed-made weights (the reference's cells use
    its own ``init`` the same way)."""
    cfg = dataclasses.replace(get_smoke_config(arch).with_policy(NATIVE_F32),
                              n_layers=n_layers, **over)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(seed)


def _ragged(vocab, n, rng, max_prompt=10, max_new=9):
    return [Request(rng.integers(0, vocab, int(rng.integers(3, max_prompt))).astype(np.int32),
                    int(rng.integers(3, max_new)), rid=i) for i in range(n)]


def _drain_with_join(eng, reqs, join_after=2):
    for r in reqs[:3]:
        eng.submit(dataclasses.replace(r))
    for _ in range(join_after):
        eng.step()
    for r in reqs[3:]:
        eng.submit(dataclasses.replace(r))
    return eng.drain()


def _logit_tol(policy_name, cfg, decode):
    tol = MODE_REL_ERROR[POLICY_CASES[policy_name][2]] * FACTOR * max(1.0, cfg.n_layers / 4)
    if decode and cfg.family == "hybrid":
        tol += CACHE_QUANTUM[cfg.kv_cache_dtype] * CACHE_FLIP_SHARE
    return tol


# ---------------------------------------------------------------------------
# parameters and logits against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_convert_and_port_init_makes_the_reference_layout(arch):
    jmodel, _, tmodel, tparams = make_pair("native_f32", arch=arch)
    own = tmodel.init(0)
    flat_t = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tparams)}
    flat_o = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(own)}
    assert set(flat_t) == set(flat_o)
    for name, v in flat_t.items():
        assert tuple(v.shape) == tuple(flat_o[name].shape), name
    if arch == "mamba2-2.7b":
        assert set(tparams["layers"]) == {"seg0_ssm"}
    else:
        # six smoke layers: two stacked supergroups, no remainder
        assert set(tparams["super"]) == {"l0_rec", "l1_rec", "l2_attn_local"}
        assert tparams["super"]["l0_rec"]["rec"]["wa"]["w"].shape[0] == 2
        assert "rem" not in tparams
    # a tree with a remainder (8 layers: 2 supergroups + rec, rec) converts too
    if arch == "recurrentgemma-9b":
        _, _, tm8, tp8 = make_pair("native_f32", arch=arch, n_layers=8)
        assert set(tp8["rem"]) == {"l0_rec", "l1_rec"}
        assert tp8["rem"]["l0_rec"]["rec"]["wa"]["w"].dim() == 2  # unstacked
        assert [ly.cache_key for ly in tm8.layers][-2:] == ["rem/l0_rec", "rem/l1_rec"]


def test_convert_refuses_the_unported_trees():
    with pytest.raises(NotImplementedError, match="hybrid block"):
        params_from_jax({"super": {"l0_moe": {}}}, device="cpu")
    with pytest.raises(NotImplementedError, match="neither"):
        params_from_jax({"embed": {}}, device="cpu")
    with pytest.raises(NotImplementedError, match="enc-dec"):
        params_from_jax({"layers": {"seg0_dec": {}}, "enc_layers": {}}, device="cpu")


@pytest.mark.parametrize("policy_name", list(POLICY_CASES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_logits_vs_reference(arch, policy_name):
    """The full-sequence forward, the prefill and eight teacher-forced
    decode steps, each against the reference's logits."""
    jmodel, jparams, tmodel, tparams = make_pair(policy_name, arch=arch)
    cfg = tmodel.cfg
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jl, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    tl, _ = tmodel.apply(tparams, {"tokens": torch.from_numpy(toks)})
    assert _gap(tl.numpy(), jl) <= _logit_tol(policy_name, cfg, False)
    js = jmodel.init_decode_state(2, 32, per_slot=True)
    ts = tmodel.init_decode_state(2, 32, per_slot=True)
    jl, js = jmodel.decode_step(jparams, jnp.asarray(toks[:, :8]), js)
    tl, ts = tmodel.decode_step(tparams, torch.from_numpy(toks[:, :8]), ts)
    assert _gap(tl.numpy(), jl) <= _logit_tol(policy_name, cfg, False)
    for i in range(8, 16):
        jl, js = jmodel.decode_step(jparams, jnp.asarray(toks[:, i:i + 1]), js)
        tl, ts = tmodel.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]), ts)
        assert _gap(tl.numpy(), jl) <= _logit_tol(policy_name, cfg, True), i
    assert np.array_equal(ts.position.numpy(), np.asarray(js.position))


@pytest.mark.parametrize("prompt_len", [6, 12])
def test_local_window_prefill_past_the_window_vs_reference(prompt_len):
    """A local-attention cache holds ``min(max_len, window)`` rows: a prompt
    longer than the window keeps only its tail (the window mask still
    reaches every prompt position), and the decode steps after it wrap the
    ring.  Both against the reference's logits, window 8."""
    jmodel, jparams, tmodel, tparams = make_pair("native_f32", arch="recurrentgemma-9b",
                                                 local_window=8)
    cfg = tmodel.cfg
    toks = np.random.default_rng(prompt_len).integers(0, cfg.vocab, (2, prompt_len + 6))
    toks = toks.astype(np.int32)
    js = jmodel.init_decode_state(2, 32, per_slot=True)
    ts = tmodel.init_decode_state(2, 32, per_slot=True)
    assert ts.caches["super/l2_attn_local"][0].k.shape[1] == 8
    jl, js = jmodel.decode_step(jparams, jnp.asarray(toks[:, :prompt_len]), js)
    tl, ts = tmodel.decode_step(tparams, torch.from_numpy(toks[:, :prompt_len]), ts)
    assert _gap(tl.numpy(), jl) <= _logit_tol("native_f32", cfg, False)
    for i in range(prompt_len, toks.shape[1]):
        jl, js = jmodel.decode_step(jparams, jnp.asarray(toks[:, i:i + 1]), js)
        tl, ts = tmodel.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]), ts)
        assert _gap(tl.numpy(), jl) <= _logit_tol("native_f32", cfg, True), i
    node = ts.caches["super/l2_attn_local"][0]
    assert np.array_equal(node.pos.numpy(), np.asarray(js.caches["super"]["l2_attn_local"].pos[0]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_forward_equals_prefill_then_decode_within_the_port(arch):
    """``apply`` over a sequence against a prefill and token-by-token decode
    steps of the same sequence (the chunked / scanned forms against the
    recurrences; the hybrid's cache adds its bf16 quantum)."""
    cfg, model, params = _tiny(arch, n_layers=3)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)))
    full, _ = model.apply(params, {"tokens": toks})
    state = model.init_decode_state(2, 32, per_slot=True)
    outs = []
    logits, state = model.decode_step(params, toks[:, :4], state)
    outs.append(logits)
    for i in range(4, 12):
        logits, state = model.decode_step(params, toks[:, i:i + 1], state)
        outs.append(logits)
    tol = 2e-5 if arch == "mamba2-2.7b" else CACHE_QUANTUM["bfloat16"]
    assert _gap(torch.cat(outs, 1).numpy(), full.numpy()) <= tol


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_tokens_vs_reference_engine(arch):
    jmodel, jparams, tmodel, tparams = make_pair("native_f32", arch=arch, n_layers=3)
    tol = _logit_tol("native_f32", tmodel.cfg, True)
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(0, 512, n).astype(np.int32), m, rid=i)
            for i, (n, m) in enumerate([(3, 6), (9, 4), (6, 6), (5, 5)])]
    jeng = JServeEngine(jmodel, jparams, batch_slots=2, max_len=32)
    want = jeng.generate_batch([JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
    got = ServeEngine(tmodel, tparams, config=ServeConfig(batch_slots=2, max_len=32)
                      ).generate_batch(reqs)
    compared = 0
    for r in reqs:
        assert len(got[r.rid]) == len(want[r.rid])
        for i, ok in enumerate(_margin_ok(jmodel, jparams, r.prompt, want[r.rid], tol)):
            if not ok:
                break  # past an undecided token the streams may diverge
            assert got[r.rid][i] == want[r.rid][i], (r.rid, i)
            compared += 1
    assert compared >= 0.8 * sum(len(v) for v in want.values())


# ---------------------------------------------------------------------------
# the reference's serving cells, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_spec_families_with_mid_flight_join(arch):
    """``tests/test_spec.py:55``: speculative drain == plain drain."""
    cfg, model, params = _tiny(arch, n_layers=3)
    reqs = _ragged(cfg.vocab, 5, np.random.default_rng(1))
    base = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=32))
    spec = ServeEngine(model, params, config=ServeConfig(
        batch_slots=2, max_len=32, spec=SpecConfig(k=3, draft_shift=1)))
    assert _drain_with_join(base, reqs) == _drain_with_join(spec, reqs)
    assert spec.metrics.acceptance_rate is not None


def test_sliding_window_ring_rollback():
    """``tests/test_spec.py:96``: a tiny window, chaotic logits — rejected
    verify writes land on live old-window ring rows, and the recurrent
    states of rejected substeps must not survive either."""
    cfg, model, params = _tiny("recurrentgemma-9b", n_layers=6, seed=2, local_window=6)
    params = jax.tree_util.tree_map(lambda p: p * 1.6, params)
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(0, cfg.vocab, int(rng.integers(3, 8))).astype(np.int32),
                    18, rid=i) for i in range(4)]
    base = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=32))
    spec = ServeEngine(model, params, config=ServeConfig(
        batch_slots=2, max_len=32, spec=SpecConfig(k=3, draft_shift=2, adapt=False)))
    for r in reqs:
        base.submit(dataclasses.replace(r))
        spec.submit(dataclasses.replace(r))
    assert base.drain() == spec.drain()
    m = spec.metrics
    assert m.spec_drafted - m.spec_accepted > 0, "no ring-wrap rejection"


def _requests(vocab, n=3, prompt_len=5, max_new=6, shared_prefix=None):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        if shared_prefix is not None:
            prompt = list(shared_prefix) + [i % vocab]
        else:
            prompt = rng.integers(0, vocab, size=prompt_len).tolist()
        reqs.append(Request(np.asarray(prompt, np.int32), max_new, rid=i))
    return reqs


def _run(model, params, reqs, **cfg_kw):
    eng = ServeEngine(model, params, config=ServeConfig(**cfg_kw))
    return eng.generate_batch(reqs), eng


PAGED = CacheConfig(layout="paged", page_size=4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_paged_matches_dense(arch):
    """``tests/test_paged.py:243`` (two layers: the hybrid's are the two
    remainder rec blocks, Mamba-2 has no KV at all)."""
    cfg, model, params = _tiny(arch)
    dense, _ = _run(model, params, _requests(cfg.vocab), batch_slots=3, max_len=16)
    paged, eng = _run(model, params, _requests(cfg.vocab), batch_slots=3, max_len=16,
                      cache=PAGED)
    assert paged == dense
    assert eng.metrics.summary()["pages"] is not None
    # two recurrent nodes per two layers, described by either layout
    assert "recurrent state: 2 per-slot dense nodes" in eng.describe_cache()
    dense_eng = ServeEngine(model, params, config=ServeConfig(batch_slots=3, max_len=16))
    assert "recurrent state: 2 per-slot dense nodes" in dense_eng.describe_cache()


@pytest.mark.parametrize("spec", [None, SpecConfig(k=3, draft_shift=2)])
def test_cow_on_hybrid_local_window_wrap(spec):
    """``tests/test_paged.py:294``: decoding past the window (cap 32 <
    max_len 48) writes back into the shared prompt pages, forcing
    copy-on-write forks; plain and speculative (a rollback across the wrap)."""
    cfg, model, params = _tiny("recurrentgemma-9b", n_layers=3)

    def mk():
        return _requests(cfg.vocab, n=3, max_new=30, shared_prefix=[7] * 8)

    dense, _ = _run(model, params, mk(), batch_slots=3, max_len=48)
    paged, eng = _run(model, params, mk(), batch_slots=3, max_len=48, cache=PAGED, spec=spec)
    assert paged == dense
    s = eng.metrics.summary()["pages"]
    assert s["cow_copies"] > 0 and s["shared_hits"] > 0


TENANTS = [Tenant("interactive", priority=0, share=2.0), Tenant("bulk", priority=2, share=1.0)]
CLASSES = [RequestClass("chat", slo_steps=8, prompt_len=6, max_new=5),
           RequestClass("batch", prompt_len=8, max_new=12)]


@pytest.mark.parametrize("cache", [None, PAGED])
@pytest.mark.parametrize("arch", FAMILIES)
def test_families_exact_under_preemption(arch, cache):
    """``tests/test_tenancy.py:86``: a parked and resumed request's tokens
    equal its solo decode — the recurrent state is parked bit for bit (no
    length arithmetic could repair it) — in the dense and the paged layout."""
    cfg, model, params = _tiny(arch)
    rng = np.random.default_rng(2)
    bulk = class_requests(CLASSES[1], TENANTS[1], 3, cfg.vocab, rng, rid_base=0)
    chat = class_requests(CLASSES[0], TENANTS[0], 2, cfg.vocab, rng, rid_base=10)
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, tenants=TENANTS,
                      classes=CLASSES, aging_steps=4, min_quantum=1,
                      cache=cache or CacheConfig())
    for r in bulk:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    for r in chat:
        eng.submit(r)
    out = eng.drain()
    check_slot_accounting(eng.scheduler)
    assert eng.scheduler.preemptions >= 1
    solo_eng = ServeEngine(model, params, config=ServeConfig(batch_slots=1, max_len=32))
    for r in bulk + chat:
        clone = Request(prompt=r.prompt, max_new=r.max_new, rid=r.rid + 1000)
        assert out[r.rid] == solo_eng.generate_batch([clone])[clone.rid], (arch, r.rid)


def test_paged_run_traces_cache_events_and_replays():
    """``tests/test_obs.py:304``: the hybrid's paged run traces prefix
    shares and copy-on-write forks, and its trace replays through the
    scheduler model."""
    cfg, model, params = _tiny("recurrentgemma-9b", n_layers=3)
    eng = ServeEngine(model, params, config=ServeConfig(
        batch_slots=3, max_len=48, cache=CacheConfig(layout="paged", page_size=4),
        trace=TraceConfig()))
    prompt = np.asarray([7] * 8, np.int32)
    for i in range(3):
        eng.submit(Request(prompt=np.append(prompt, i).astype(np.int32), max_new=30, rid=i))
    eng.drain()
    kinds = {e.kind for e in eng.tracer.events}
    assert "prefix_share" in kinds and "cow_fork" in kinds
    assert all(e.cause == "shared_page_write" for e in eng.tracer.events if e.kind == "cow_fork")
    check_replay(eng)


# ---------------------------------------------------------------------------
# the recurrent state through the serving layouts and the rollback
# ---------------------------------------------------------------------------


def _filled_state(layout, model, params, lengths=(5, 9)):
    """The layout's state with rows 0 and 1 prefilled (non-zero recurrent
    states, KV where the model has it)."""
    state = layout.init()
    rng = np.random.default_rng(7)
    for slot, n in enumerate(lengths):
        prompt = rng.integers(0, model.cfg.vocab, n).astype(np.int32)
        _, solo = model.decode_step(params, torch.from_numpy(prompt[None].astype(np.int64)),
                                    model.init_decode_state(1, layout.max_len, per_slot=True))
        state = layout.scatter_row(state, solo, slot, prompt=prompt)
    return state


@pytest.mark.parametrize("layout_name", ["dense", "paged"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_park_and_resume_round_trip_bit_for_bit(arch, layout_name):
    """gather_row -> scatter_row into another slot -> gather_row again gives
    the same row bit for bit, recurrent nodes included; the other rows are
    untouched."""
    cfg, model, params = _tiny(arch, n_layers=3)
    layout = (DenseLayout(model, 3, 24) if layout_name == "dense"
              else PagedLayout(model, 3, 24, CacheConfig(layout="paged", page_size=4)))
    state = _filled_state(layout, model, params)
    row = layout.gather_row(state, 1)
    kinds = {type(n[0]) for n in row.caches.values()}
    assert (SSMState in kinds) or (RGLRUState in kinds)
    assert any(float(x.abs().sum()) > 0 for x in state_leaves(row))
    other = [x.clone() for x in state_leaves(layout.gather_row(state, 0))]
    state = layout.free_row(state, 1)
    state = layout.scatter_row(state, row, 2, length=9)
    again = layout.gather_row(state, 2)
    for a, b in zip(state_leaves(row), state_leaves(again), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(other, state_leaves(layout.gather_row(state, 0)), strict=True):
        assert torch.equal(a, b)
    if layout_name == "paged":
        for key, nodes in state.caches.items():
            kv = isinstance(nodes[0], (KVCache, PagedKVCache))
            assert isinstance(nodes[0], PagedKVCache) == kv
            assert key in layout.state_keys or kv


def test_rollback_takes_each_slots_recurrent_snapshot_at_n_acc():
    """Per slot, the recurrent nodes come from the verify substep at
    ``n_acc`` (bit for bit); inactive slots keep the pre-round state."""
    cfg, model, params = _tiny("recurrentgemma-9b", n_layers=2)  # two rec blocks
    layout = DenseLayout(model, 3, 16)
    state0 = _filled_state(layout, model, params, lengths=(4, 6, 3))
    tok = torch.tensor([[1], [2], [3]], dtype=torch.int32)
    snaps, st = [], state0
    for _ in range(4):
        _, st = model.decode_step(params, tok, st)
        snaps.append(snapshot(st))
    n_acc = torch.tensor([0, 3, 2], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    out = rollback(layout.axes, state0, st, snaps, n_acc, active)
    for key, nodes in out.caches.items():
        for li, node in enumerate(nodes):
            for f in dataclasses.fields(node):
                got = getattr(node, f.name)
                for b, j in ((0, 0), (1, 3)):
                    assert torch.equal(got[b], getattr(snaps[j].caches[key][li], f.name)[b])
                assert torch.equal(got[2], getattr(state0.caches[key][li], f.name)[2])
    assert out.position.tolist() == [state0.position[0] + 1, state0.position[1] + 4,
                                     state0.position[2]]


# ---------------------------------------------------------------------------
# compiled steps: a dropped engine dies at once
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arm", ["plain", "spec", "adapt", "paged"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b"] + FAMILIES)
def test_dropped_engine_dies_without_a_cycle_collection(arch, arm):
    """The engine's compiled steps hold it weakly: with the cycle collector
    off, dropping the last reference frees the engine (and on the card its
    graphs' memory pool) at once; ``close()`` drops the graphs explicitly."""
    cfg, model, params = _tiny(arch, n_layers=3)
    kw = {"plain": {}, "spec": {"spec": SpecConfig(k=2)},
          "adapt": {"adapt": AdaptConfig(slo=SLO(max_err=0.5), adapt_every=1)},
          "paged": {"cache": PAGED}}[arm]
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        eng = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=24, **kw))
        eng.generate_batch([Request(np.arange(1, 6, dtype=np.int32), 4, rid=0)])
        eng.close()
        eng.generate_batch([Request(np.arange(2, 7, dtype=np.int32), 3, rid=1)])
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_serves_the_family_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-new", "4", "--prompt-len", "8", "--paged",
                       "--page-size", "4", "--speculate", "--draft-k", "2"])
    out = capsys.readouterr().out
    assert "recurrent state" in out and "acceptance" in out
    assert "3/3" in out or "from 3/3 requests" in out
