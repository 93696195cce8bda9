"""Port vs reference, the MoE family served: ``phi3.5-moe-42b-a6.6b`` (two
MoE layers) and ``kimi-k2-1t-a32b`` (a dense first layer, then two MoE
layers with a shared expert) at the smoke size under native f32, through
every engine path: plain, modal (``slo=``), speculative, paged,
paged-speculative, and two tenants with a preemption (park / resume).

The rows of a MoE decode step are coupled: the step routes the whole slot
array as one group, inactive slots included, with ``ceil(B * top_k / E) *
cf`` slots an expert, and an assignment past an expert's capacity is
dropped (``models/moe.py``).  So batched tokens need not equal a request's
solo decode, nor speculative tokens the plain arm's (the verify substeps
route the draft tokens of every row together) — on the reference's own
engine as well (``test_speculative_tokens_differ_from_plain_on_the_reference``).
Each arm of the port is therefore held against the reference's engine in
the SAME arm, on the same numpy-made weights, under the margin rule of
``test_torch_serve``: a token is compared while the reference's top-2
logit margin exceeds twice the logit tolerance, and no routing decision of
the port's run so far lay within ``ROUTE_TOL`` of a tie (a routing flip
between the packages' f32 sums would couple into every row; counted as
undecided from the step it happens in).  The margin rule must leave at
least 80 % of the tokens to compare.

For the same reasons paged tokens need not equal dense tokens: an inactive
slot still routes with the others, reading its frozen cache in the dense
layout and the scratch page in the paged one (its table is cleared); and a
prefill routes the whole prompt as one group (every token's first choice
before any second choice), so a shared prefix page holds K/V that the
first request's suffix helped route.  The reference's engines differ the
same way on the same traffic
(``test_paged_and_dense_differ_only_where_the_reference_does``)."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.adapt import SLO as JSLO
from repro.serve import CacheConfig as JCacheConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest
from repro.serve.tenancy import RequestClass as JRequestClass
from repro.serve.tenancy import Tenant as JTenant
from repro.spec import SpecConfig as JSpecConfig

from repro_torch.adapt import SLO
from repro_torch.core.precision import Mode
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import paged_cache_init, write_pool_slots
from repro_torch.plan import MODE_REL_ERROR
from repro_torch.serve import CacheConfig, Request, RequestClass, ServeEngine, Tenant
from repro_torch.spec import SpecConfig

from test_torch_common import CACHE_FLIP_SHARE, CACHE_QUANTUM, FACTOR, make_pair
from test_torch_graphs import _config, _functional_decode, _held_modes
from test_torch_serve import _margin_ok

PHI = "phi3.5-moe-42b-a6.6b"
KIMI = "kimi-k2-1t-a32b"
#: depth of each arch's smoke model: Kimi keeps its dense first layer
LAYERS = {PHI: 2, KIMI: 3}
SLOTS = 3
MAX_LEN = 32
#: the logit tolerance of native f32 at these depths, with the bf16 cache's
#: share on top (decode steps read a cache each package filled itself)
TOL = MODE_REL_ERROR[Mode.M24] * FACTOR + CACHE_QUANTUM["bfloat16"] * CACHE_FLIP_SHARE
#: a routing decision is undecided where the k-th and (k+1)-th router logits
#: lie within twice native f32's logit tolerance of the router logits' scale
#: (the router reads the hidden state, not a logit that a cache code's flip
#: moved: TOL's cache share would flag most steps of a long run)
ROUTE_TOL = 2 * MODE_REL_ERROR[Mode.M24] * FACTOR

#: arm: (reference engine kwargs, port engine kwargs)
ARMS = {
    "plain": ({}, {}),
    "modal": (dict(slo=JSLO(max_err=0.5), adapt_every=2),
              dict(slo=SLO(max_err=0.5), adapt_every=2)),
    "spec": (dict(speculate=JSpecConfig(k=2, draft_shift=1)),
             dict(speculate=SpecConfig(k=2, draft_shift=1))),
    "paged": (dict(cache=JCacheConfig(layout="paged", page_size=4)),
              dict(cache=CacheConfig(layout="paged", page_size=4))),
    "paged_spec": (dict(cache=JCacheConfig(layout="paged", page_size=4),
                        speculate=JSpecConfig(k=2, draft_shift=1)),
                   dict(cache=CacheConfig(layout="paged", page_size=4),
                        speculate=SpecConfig(k=2, draft_shift=1))),
    "tenants": (dict(tenants=[JTenant("interactive", priority=0, share=2.0),
                              JTenant("bulk", priority=2, share=1.0)],
                     classes=[JRequestClass("chat", slo_steps=8), JRequestClass("batch")],
                     aging_steps=4, min_quantum=1),
                dict(tenants=[Tenant("interactive", priority=0, share=2.0),
                              Tenant("bulk", priority=2, share=1.0)],
                     classes=[RequestClass("chat", slo_steps=8), RequestClass("batch")],
                     aging_steps=4, min_quantum=1)),
}


@pytest.fixture(scope="module", params=[PHI, KIMI])
def pair(request):
    return make_pair("native_f32", arch=request.param, n_layers=LAYERS[request.param])


def _schedule(arm: str, vocab: int) -> list[tuple[int, dict]]:
    """(engine step to submit before, request fields): ragged requests, more
    than the slots (slot reuse, inactive rows in the routed group); for the
    tenants arm, bulk work first and urgent chat requests three steps later
    (a preemption)."""
    rng = np.random.default_rng(3)

    def req(rid, n, m, **kw):
        return dict(prompt=rng.integers(0, vocab, n).astype(np.int32), max_new=m, rid=rid, **kw)

    if arm == "tenants":
        bulk = [(0, req(i, n, 12, tenant="bulk", rclass="batch"))
                for i, n in enumerate((6, 8, 5))]
        chat = [(3, req(10 + i, n, 5, tenant="interactive", rclass="chat"))
                for i, n in enumerate((4, 7))]
        return bulk + chat
    return [(0, req(i, n, m)) for i, (n, m) in enumerate([(3, 6), (9, 4), (6, 6), (5, 5),
                                                          (7, 6)])]


def _run(eng, schedule, make_request, on_step=None):
    """Submit on schedule and step to the end.  Returns (tokens per rid, the
    engine step each token was emitted in)."""
    tokens, at = {}, {}
    pending = sorted(schedule, key=lambda s: s[0])
    step = 0
    while pending or eng.scheduler.has_work():
        while pending and pending[0][0] <= step:
            eng.submit(make_request(**pending.pop(0)[1]))
        events = eng.step()
        if on_step is not None:
            on_step(step)
        for rid, tok in events:
            tokens.setdefault(rid, []).append(tok)
            at.setdefault(rid, []).append(step)
        step += 1
    return tokens, at


class _RoutingMargins:
    """Wraps the port's ``moe._route`` while installed: the engine step in
    which a token's k-th and (k+1)-th router logits first lay within
    ``ROUTE_TOL`` of the router logits' scale (None if never)."""

    def __init__(self, monkeypatch, k: int):
        self.k, self.tied_now, self.first_tied_step = k, False, None
        route = tmoe._route

        def wrapped(x, router_w, cfg):
            logits = np.sort((x.double() @ router_w.double()).numpy(), axis=-1)[..., ::-1]
            gap = logits[..., self.k - 1] - logits[..., self.k]
            if (gap <= ROUTE_TOL * np.abs(logits).max()).any():
                self.tied_now = True
            return route(x, router_w, cfg)

        monkeypatch.setattr(tmoe, "_route", wrapped)

    def after_step(self, step: int) -> None:
        if self.tied_now and self.first_tied_step is None:
            self.first_tied_step = step
        self.tied_now = False


def _arm_run(pair, arm, monkeypatch):
    jmodel, jparams, tmodel, tparams = pair
    jkw, tkw = ARMS[arm]
    schedule = _schedule(arm, tmodel.cfg.vocab)
    jeng = JServeEngine(jmodel, jparams, batch_slots=SLOTS, max_len=MAX_LEN, **jkw)
    want, _ = _run(jeng, schedule, JRequest)
    margins = _RoutingMargins(monkeypatch, tmodel.cfg.moe_top_k)
    teng = ServeEngine(tmodel, tparams, batch_slots=SLOTS, max_len=MAX_LEN, **tkw)
    got, at = _run(teng, schedule, Request, margins.after_step)
    return jeng, teng, schedule, want, got, at, margins.first_tied_step


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_tokens_vs_reference_engine_in_the_same_arm(pair, arm, monkeypatch):
    jmodel, jparams, _, _ = pair
    jeng, teng, schedule, want, got, at, tied_step = _arm_run(pair, arm, monkeypatch)
    assert sorted(got) == sorted(want)
    compared = 0
    for _, fields in schedule:
        rid = fields["rid"]
        assert len(got[rid]) == len(want[rid]), rid
        for i, ok in enumerate(_margin_ok(jmodel, jparams, fields["prompt"], want[rid], TOL)):
            if not ok or (tied_step is not None and at[rid][i] >= tied_step):
                break  # past an undecided token the streams may diverge
            assert got[rid][i] == want[rid][i], (arm, rid, i)
            compared += 1
    assert compared >= 0.8 * sum(len(v) for v in want.values())
    js, ts = jeng.metrics.summary(), teng.metrics.summary()
    for key in ("tokens_out", "requests", "completed"):
        assert ts[key] == js[key], key
    if arm == "tenants":
        assert teng.scheduler.preemptions == jeng.scheduler.preemptions >= 1
    if "spec" in arm:
        assert teng.metrics.spec_rounds > 0
    if arm == "modal":
        assert [lab for _, lab in teng.metrics.mode_timeline] == \
            [lab for _, lab in jeng.metrics.mode_timeline]
    if "paged" in arm:
        for key in ("pages_used", "shared_hits", "cow_copies", "occupancy_peak"):
            assert ts["pages"][key] == js["pages"][key], key


def test_speculative_tokens_differ_from_plain_on_the_reference():
    """The row coupling is the reference's own: with 4 slots, speculation
    (k = 3, draft shift 2) emits other tokens than the plain engine for one
    request of this traffic — and the port does the same in both arms.
    A later change must not make the port's arms equal where the
    reference's are not."""
    jmodel, jparams, tmodel, tparams = make_pair("native_f32", arch=PHI, n_layers=2)
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(0, 512, int(rng.integers(3, 10))).astype(np.int32), 8, rid=i)
            for i in range(4)]

    def both(**kw):
        jkw = {"speculate": JSpecConfig(k=3, draft_shift=2)} if kw else {}
        want = JServeEngine(jmodel, jparams, batch_slots=4, max_len=MAX_LEN, **jkw).generate_batch(
            [JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
        got = ServeEngine(tmodel, tparams, batch_slots=4, max_len=MAX_LEN, **kw).generate_batch(
            [dataclasses.replace(r) for r in reqs])
        return want, got

    j_plain, t_plain = both()
    j_spec, t_spec = both(speculate=SpecConfig(k=3, draft_shift=2))
    assert j_spec != j_plain
    differing = [rid for rid in j_plain if j_plain[rid] != j_spec[rid]]
    assert t_plain == j_plain and t_spec == j_spec, differing
    assert t_spec != t_plain


@pytest.mark.parametrize("arm", ["plain", "modal", "spec"])
def test_one_slot_engine_equals_the_functional_decode(pair, arm):
    """The engine's compiled steps on their static inputs and state, at one
    slot (a routed group of one row: no coupling), give the tokens of
    ``decode_step`` alone on a state it returns each step; the modal step
    at the held table's host ints; speculation the plain greedy tokens."""
    _, _, model, params = pair
    eng = ServeEngine(model, params, config=_config(arm, slots=1))
    reqs = [Request(np.random.default_rng(i).integers(0, 512, n).astype(np.int32), m, rid=i)
            for i, (n, m) in enumerate([(3, 6), (9, 4), (6, 7)])]
    outs = eng.generate_batch([dataclasses.replace(r) for r in reqs])
    modes = _held_modes(model) if arm == "modal" else None
    for r in reqs:
        assert outs[r.rid] == _functional_decode(model, params, r, modes), r.rid
    assert eng.graph_capture_count == 0  # the CPU runs the steps eagerly
    if arm == "spec":
        assert eng.metrics.spec_rounds > 0


def test_paged_and_dense_differ_only_where_the_reference_does(pair):
    """Paged against dense over a shared prompt prefix, on both packages:
    each of the port's layouts gives the reference's tokens in that layout,
    and the port's paged and dense tokens are equal exactly where the
    reference's are.  (On Kimi's smoke model they differ for one request.)"""
    jmodel, jparams, model, params = pair
    prefix = [7] * 8
    reqs = [Request(np.asarray(prefix + [i], np.int32), 4 + 2 * i, rid=i) for i in range(4)]
    out = {}
    for name, jkw, tkw in (("dense", {}, {}),
                           ("paged", dict(cache=JCacheConfig(layout="paged", page_size=4)),
                            dict(cache=CacheConfig(layout="paged", page_size=4)))):
        out["j" + name] = JServeEngine(jmodel, jparams, batch_slots=SLOTS, max_len=MAX_LEN,
                                       **jkw).generate_batch(
            [JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
        eng = ServeEngine(model, params, batch_slots=SLOTS, max_len=MAX_LEN, **tkw)
        out["t" + name] = eng.generate_batch([dataclasses.replace(r) for r in reqs])
    assert out["tdense"] == out["jdense"] and out["tpaged"] == out["jpaged"]
    assert eng.metrics.summary()["pages"]["shared_hits"] > 0
    for r in reqs:
        assert ((out["tpaged"][r.rid] == out["tdense"][r.rid])
                == (out["jpaged"][r.rid] == out["jdense"][r.rid])), r.rid
    if model.cfg.name == KIMI:
        assert out["jpaged"] != out["jdense"]  # the coupling this test records


def test_decode_step_drops_the_aux_loss_and_apply_sums_it(pair):
    """``apply`` returns the MoE layers' summed load-balance loss (each at
    least 1, the Switch form's lower bound), as the reference's does;
    ``decode_step`` returns logits only."""
    jmodel, jparams, tmodel, tparams = pair
    toks = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    _, jaux = jmodel.apply(jparams, {"tokens": jnp.asarray(toks)})
    _, taux = tmodel.apply(tparams, {"tokens": torch.from_numpy(toks)})
    n_moe = sum(1 for ly in tmodel.layers if ly.kind == "moe")
    assert n_moe == 2 and float(taux) >= n_moe * (1.0 - 1e-3)
    assert abs(float(taux) - float(jaux)) <= 1e-5 * float(jaux)
    logits, state = tmodel.decode_step(tparams, torch.from_numpy(toks[:, :4]),
                                       tmodel.init_decode_state(2, 16, per_slot=True))
    assert logits.shape == (2, 4, 512) and state.position.tolist() == [4, 4]


@pytest.mark.parametrize("argv", [
    ["--arch", PHI, "--smoke", "--device", "cpu"],
    ["--arch", KIMI, "--smoke", "--device", "cpu", "--speculate", "--paged"],
    ["--arch", PHI, "--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
     "--max-new", "4", "--adapt", "--accuracy", "2e-4"],
])
def test_launcher_serves_the_moe_family_on_the_cpu(argv, capsys):
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "from 4/4 requests" in out or "from 3/3 requests" in out
    if "--speculate" in argv:
        assert "acceptance" in out and "paged cache" in out
    if "--accuracy" in argv:
        assert "moe_expert" in out and "router" in out  # the planner's MoE sites


def test_duplicate_pool_writes_land_the_last_writes_value():
    """Rows whose tables are unmapped write the scratch page together: every
    write to a slot carries the value of the last write to it, so the slot
    ends as a sequential scatter leaves it, whatever order the device
    applies the duplicates in."""
    node = paged_cache_init(2, 8, 1, 2, "bfloat16", n_pages=4, page_size=4)
    pages = torch.tensor([[0, 0, 3], [0, 2, 0]])
    off = torch.tensor([[1, 1, 0], [1, 2, 3]])
    vals = torch.arange(12, dtype=torch.float32).reshape(2, 3, 1, 2)
    write_pool_slots(node, pages, off, {"k_pool": vals, "v_pool": -vals})
    k = node.k_pool.float()
    assert torch.equal(k[0, 1], vals[1, 0])  # three writes to (0, 1): the last wins
    assert torch.equal(k[0, 3], vals[1, 2]) and torch.equal(k[3, 0], vals[0, 2])
    assert torch.equal(node.v_pool.float()[0, 1], -vals[1, 0])


def test_paged_moe_serving_repeats_exactly_under_a_thread_pool():
    """Two runs of one paged MoE engine give the same tokens with a pool of
    PyTorch threads (whose duplicate writes to the scratch page would
    otherwise land in any order, and an inactive row routes from what it
    reads there)."""
    _, _, model, params = make_pair("native_f32", arch=PHI, n_layers=3)
    rng = np.random.default_rng(31)
    prefix = rng.integers(0, 512, 32)
    reqs = [Request(np.concatenate([prefix, rng.integers(0, 512, int(rng.integers(8, 25)))])
                    .astype(np.int32), int(rng.integers(16, 33)), rid=i) for i in range(8)]
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [ServeEngine(model, params, batch_slots=4, max_len=96,
                            cache=CacheConfig(layout="paged", page_size=16)).generate_batch(
                                [dataclasses.replace(r) for r in reqs]) for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    assert runs[0] == runs[1] == runs[2]
