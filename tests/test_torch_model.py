"""Port vs reference, the dense model as a whole: parameters made with numpy
from a seed go into ``repro`` (as a JAX pytree) and, through
``repro_torch.convert.params_from_jax``, into the port; prefill logits and
eight teacher-forced decode steps are compared at the smoke size
(4 layers, d_model 128, vocab 512), for three policies and both KV dtypes.

Tolerance.  Both packages run the same arithmetic on the same numbers; they
differ in the order f32 partial sums are added (~1e-7 relative per product),
in ``theta ** (-i/half)`` and ``cos``/``sin`` (an ulp), and — below M24 — in
which way a value that lands on a bf16 rounding boundary after such a
difference is rounded (one unit of the mode's ceiling, for a few elements).
So logits are held to ``MODE_REL_ERROR[mode] * FACTOR`` of the logit scale,
with ``FACTOR = 4`` for the four layers the error passes through.  A decode
step that reads a cache the port filled itself is allowed, on top, a stated
share of one cache quantum (see ``CACHE_FLIP_SHARE``); one that starts from
the reference's cache is compared code by code in the row it appends (see
``test_prefill_and_decode_logits_vs_reference``)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.policy import PRESETS as J_POLICIES
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.core.precision import Mode as JMode
from repro.models import layers as jlayers

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import PRESETS, PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.plan import MODE_REL_ERROR

from test_torch_common import (
    ARCH,
    APPENDED_FLIP_LIMIT_SHARE,
    CACHE_FLIP_SHARE,
    CACHE_QUANTUM,
    DECODE_STEPS,
    FACTOR,
    POLICY_CASES,
    _gap,
    make_pair,
    state_from_jax,
)

def test_configs_equal_field_by_field():
    from repro.configs import get_config as j_get_config

    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:  # every id, full and smoke size (reduce_for_smoke)
        for make_t, make_j in ((get_smoke_config, j_get_smoke_config),
                               (get_config, j_get_config)):
            t, j = make_t(arch), make_j(arch)
            for f in dataclasses.fields(t):
                if f.name == "policy":
                    continue
                assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff, full.vocab,
            full.qkv_bias) == (24, 1024, 16, 2816, 151936, True)
    ssm = get_config("mamba2-2.7b")
    assert (ssm.family, ssm.n_layers, ssm.d_model, ssm.ssm_state, ssm.vocab) == (
        "ssm", 64, 2560, 128, 50280)
    hyb = get_config("recurrentgemma-9b")
    assert (hyb.family, hyb.n_layers, hyb.d_model, hyb.d_ff, hyb.vocab, hyb.local_window,
            hyb.tie_embeddings) == ("hybrid", 38, 4096, 12288, 256000, 2048, False)
    assert sorted(PRESETS) == sorted(J_POLICIES)
    # every family is ported; an unknown id is what raises
    moe = get_config("phi3.5-moe-42b-a6.6b")
    assert (moe.family, moe.moe_experts, moe.moe_top_k, moe.d_ff) == ("moe", 16, 2, 6400)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("phi3.5-moe-42b")


def test_params_from_jax_keeps_layout_and_port_init_matches_it():
    jmodel, _, tmodel, tparams = make_pair("native_f32")
    own = tmodel.init(0)
    flat_t = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tparams)}
    flat_o = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(own)}
    assert set(flat_t) == set(flat_o)
    for name, v in flat_t.items():
        assert tuple(v.shape) == tuple(flat_o[name].shape), name
        assert v.dtype == torch.float32 and v.device.type == "cpu"
    w = tparams["layers"]["seg0_dense"]["mlp"]["up"]["w"]
    assert tuple(w.shape) == (4, 128, 256)  # (layers, d_in, d_out): used as x @ w
    # moe (a dense segment then a moe one) and enc-dec trees convert (the
    # ssm and hybrid ones: test_torch_families; every family:
    # test_torch_archs); a segment of an unknown block kind, or an encoder
    # stack without a decoder, is refused
    kimi = params_from_jax({"layers": {"seg0_dense": {"w": np.ones(2)},
                                       "seg1_moe": {"w": np.ones(3)}}}, device="cpu")
    assert sorted(kimi["layers"]) == ["seg0_dense", "seg1_moe"]
    assert params_from_jax({"layers": {"seg0_dec": {}}, "enc_layers": {}},
                           device="cpu")["enc_layers"] == {}
    with pytest.raises(NotImplementedError, match="unknown layer segments"):
        params_from_jax({"layers": {"seg0_dense": {}, "seg1_conv": {}}}, device="cpu")
    with pytest.raises(NotImplementedError, match="enc-dec"):
        params_from_jax({"layers": {"seg0_dense": {}}, "enc_layers": {}}, device="cpu")
    with pytest.raises(RuntimeError, match="found no GPU"):
        if torch.cuda.is_available():
            raise RuntimeError("found no GPU (skipped: a GPU is present)")
        build_model(get_smoke_config(ARCH))


def _code_steps(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """Per stored value, how many codes apart two caches are: adjacent bf16
    values of one sign are adjacent 16-bit patterns; int8 codes are ints."""
    if got.dtype == torch.bfloat16:
        got_i = got.view(torch.int16).numpy().astype(np.int64)
        want_i = np.asarray(want).view(np.int16).astype(np.int64)
    else:
        got_i = got.numpy().astype(np.int64)
        want_i = np.asarray(want).astype(np.int64)
    return np.abs(got_i - want_i)


def _appended_flips(state, jstate, col: int) -> int:
    """Codes of the row a step appended (cache column ``col``) in which the
    port's cache differs from the reference's, over every layer, K and V.
    Each must be ONE code from the reference's: a value the frameworks
    computed an ulp apart that lay on a rounding boundary.  At most
    ``APPENDED_FLIP_LIMIT_SHARE`` of the row's codes may differ."""
    jc = jstate.caches["seg0_dense"]
    steps = np.concatenate([
        _code_steps(getattr(node, name)[:, col], np.asarray(getattr(jc, name)[li][:, col])).ravel()
        for li, node in enumerate(state.caches["seg0_dense"]) for name in ("k", "v")])
    assert steps.max() <= 1, f"a stored code is {steps.max()} codes from the reference's"
    flips = int((steps > 0).sum())
    assert flips <= APPENDED_FLIP_LIMIT_SHARE * steps.size, (flips, steps.size)
    return flips


def _with_reference_row(monkeypatch, jstate, col: int):
    """Patch the port's cache append so that every layer stores, in column
    ``col``, the reference's codes (and int8 scales) of ``jstate`` — the
    step then reads back exactly what the reference's step read."""
    jc = jstate.caches["seg0_dense"]
    append, calls = tlayers.kv_append, []

    def kv_append(cache, k_new, v_new):
        out = append(cache, k_new, v_new)
        li = len(calls)
        calls.append(li)
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(out, name) is not None:
                ref = np.array(getattr(jc, name)[li][:, col], dtype=np.float32)
                getattr(out, name)[:, col] = torch.from_numpy(ref).to(getattr(out, name).dtype)
        return out

    monkeypatch.setattr(tlayers, "kv_append", kv_append)
    return calls


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("policy_name", list(POLICY_CASES))
def test_prefill_and_decode_logits_vs_reference(policy_name, kv_dtype, monkeypatch):
    """Three gaps, each against the reference's logits: the prefill; every
    decode step run from the reference's own cache; and every decode step
    run from the port's own cache (the ceiling plus a share of one cache
    quantum: of ~10^4 stored values a few round to the neighbouring code).

    A step from the reference's cache computes the same function, except
    that the row it appends (and reads back) is the port's own: a value the
    two frameworks computed an ulp apart can round to the neighbouring cache
    code.  So the appended row is compared code by code: every differing
    code is one code from the reference's, and at most
    ``APPENDED_FLIP_LIMIT_SHARE`` (1/64) of the row's codes differ — at the
    ceiling ``tol`` about 2 * tol / 2^-8 = 1e-3 of bf16 codes lie close
    enough to a rounding boundary to flip, while a wrong rounding of the
    appended row moves about half of them.  Then:

    * the same step with the reference's codes stored in the appended row
      (``_with_reference_row``) is held to ``tol``, with no cache
      allowance — so a step with no differing code is too;
    * the step as the port runs it gets, per flipped code, the effect of
      one cache quantum (``CACHE_QUANTUM``: the distance to the neighbouring
      code, relative) read at attention weight at most 1 — the appended row
      is one position of the softmax, and a weight cannot exceed 1 — of
      which at most ``CACHE_FLIP_SHARE`` reaches the logit scale, the share
      the own-cache gap grants any flipped stored value."""
    jmodel, jparams, tmodel, tparams = make_pair(policy_name, kv_dtype)
    jstep = jax.jit(jmodel.decode_step)
    tol = MODE_REL_ERROR[POLICY_CASES[policy_name][2]] * FACTOR
    tol_own = tol + CACHE_QUANTUM[kv_dtype] * CACHE_FLIP_SHARE
    per_flip = CACHE_QUANTUM[kv_dtype] * CACHE_FLIP_SHARE
    rng = np.random.default_rng(1)
    batch, prompt_len, max_len = 2, 11, 32
    prompt = rng.integers(0, jmodel.cfg.vocab, (batch, prompt_len)).astype(np.int32)

    jlogits, jstate = jstep(jparams, jnp.asarray(prompt), jmodel.init_decode_state(batch, max_len))
    tlogits, tstate = tmodel.decode_step(tparams, torch.from_numpy(prompt),
                                         tmodel.init_decode_state(batch, max_len))
    assert tuple(tlogits.shape) == (batch, prompt_len, jmodel.cfg.vocab)
    assert tlogits.dtype == torch.float32 and bool(torch.isfinite(tlogits).all())
    assert _gap(tlogits.numpy(), jlogits) <= tol
    gaps_same, gaps_swapped, gaps_own, flips, compared = [], [], [], [], 0
    for _ in range(DECODE_STEPS):
        # teacher-forced: both packages are fed the reference's greedy token;
        # tokens are compared only where the reference's top-2 margin exceeds
        # the tolerance on the logits
        jl = np.asarray(jlogits[:, -1])
        nxt = jl.argmax(-1).astype(np.int32)[:, None]
        top2 = np.sort(jl, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * tol_own * np.abs(jl).max()
        assert np.array_equal(tlogits[:, -1].argmax(-1).numpy()[decided], nxt[:, 0][decided])
        compared += int(decided.sum())
        tok = torch.from_numpy(nxt.copy())
        col = int(np.asarray(jstate.caches["seg0_dense"].length)[0]) % max_len
        j_before = jstate
        same, same_state = tmodel.decode_step(tparams, tok, state_from_jax(j_before))
        tlogits, tstate = tmodel.decode_step(tparams, tok, tstate)
        jlogits, jstate = jstep(jparams, jnp.asarray(nxt), jstate)
        flips.append(_appended_flips(same_state, jstate, col))
        with monkeypatch.context() as mp:
            calls = _with_reference_row(mp, jstate, col)
            swapped, _ = tmodel.decode_step(tparams, tok, state_from_jax(j_before))
        assert len(calls) == tmodel.cfg.n_layers
        gaps_same.append(_gap(same.numpy(), jlogits))
        gaps_swapped.append(_gap(swapped.numpy(), jlogits))
        gaps_own.append(_gap(tlogits.numpy(), jlogits))
    assert max(gaps_swapped) <= tol, (policy_name, kv_dtype, gaps_swapped)
    for gap, n in zip(gaps_same, flips):
        assert gap <= tol + n * per_flip, (policy_name, kv_dtype, gaps_same, flips)
    assert max(gaps_own) <= tol_own, (policy_name, kv_dtype, gaps_own)
    assert compared > 0  # the margin rule left tokens to compare
    assert int(tstate.position) == int(jstate.position) == prompt_len + DECODE_STEPS
    tc, jc = tstate.caches["seg0_dense"][0], jstate.caches["seg0_dense"]
    assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos[0]))
    assert int(tc.length) == int(jc.length[0])


@pytest.mark.parametrize("impl", ["pallas", "tile"])
def test_kernel_impl_policies_vs_reference(impl):
    """M16 through the kernel wrappers: the port runs the plain versions, the
    reference its Pallas kernels in interpret mode."""
    tpol = PrecisionPolicy(default=Mode.M16, impl=impl)
    jpol = JPolicy(default=JMode.M16, impl=impl)
    POLICY_CASES["_kernel"] = (tpol, jpol, Mode.M16)
    try:
        jmodel, jparams, tmodel, tparams = make_pair("_kernel", n_layers=2)
    finally:
        del POLICY_CASES["_kernel"]
    prompt = np.random.default_rng(2).integers(0, 512, (1, 9)).astype(np.int32)
    jlogits, _ = jmodel.decode_step(jparams, jnp.asarray(prompt),
                                    jmodel.init_decode_state(1, 16))
    tlogits, _ = tmodel.decode_step(tparams, torch.from_numpy(prompt),
                                    tmodel.init_decode_state(1, 16))
    assert _gap(tlogits.numpy(), jlogits) <= MODE_REL_ERROR[Mode.M16] * FACTOR


def test_per_slot_state_equals_shared_state_and_reference():
    jmodel, jparams, tmodel, tparams = make_pair("native_f32")
    prompt = np.random.default_rng(3).integers(0, 512, (2, 7)).astype(np.int32)
    shared, _ = tmodel.decode_step(tparams, torch.from_numpy(prompt),
                                   tmodel.init_decode_state(2, 16))
    slots, st = tmodel.decode_step(tparams, torch.from_numpy(prompt),
                                   tmodel.init_decode_state(2, 16, per_slot=True))
    assert torch.equal(shared, slots)
    assert tuple(st.position.shape) == (2,) and st.position.tolist() == [7, 7]
    jslots, jst = jmodel.decode_step(jparams, jnp.asarray(prompt),
                                     jmodel.init_decode_state(2, 16, per_slot=True))
    assert _gap(slots.numpy(), jslots) <= MODE_REL_ERROR[Mode.M24] * FACTOR
    assert np.array_equal(st.caches["seg0_dense"][1].pos.numpy(),
                          np.asarray(jst.caches["seg0_dense"].pos[1]))


def test_decode_step_does_not_modify_the_state_it_is_given():
    _, _, tmodel, tparams = make_pair("native_f32")
    state = tmodel.init_decode_state(1, 8, per_slot=True)
    before = [c.k.clone() for c in state.caches["seg0_dense"]]
    tmodel.decode_step(tparams, torch.tensor([[1, 2, 3]]), state)
    assert all(torch.equal(c.k, b) for c, b in zip(state.caches["seg0_dense"], before))
    assert state.position.tolist() == [0]


def test_apply_full_sequence_vs_reference_and_decode():
    jmodel, jparams, tmodel, tparams = make_pair("M24")
    tokens = np.random.default_rng(4).integers(0, 512, (2, 13)).astype(np.int32)
    jlogits, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens)})
    tlogits, aux = tmodel.apply(tparams, {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    assert _gap(tlogits.numpy(), jlogits) <= MODE_REL_ERROR[Mode.M24] * FACTOR
    # the cached prefill computes the same function as the full forward
    cached, _ = tmodel.decode_step(tparams, torch.from_numpy(tokens),
                                   tmodel.init_decode_state(2, 16))
    assert _gap(cached.numpy(), tlogits.numpy()) <= MODE_REL_ERROR[Mode.M24] * FACTOR


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rope_vs_reference():
    """``theta ** (-i/half)`` and cos/sin differ by an ulp between the
    frameworks and the angle grows with the position: at position p the
    rotated value differs by about p * 2^-23 of its size."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    for pos in (np.arange(6, dtype=np.int32),
                np.array([[0, 1, 2, 3, 4, 5], [90, 91, 92, 93, 94, 95]], np.int32)):
        want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
        got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy()
        assert np.abs(got - want).max() <= (int(pos.max()) + 4) * 2.0**-23 * np.abs(x).max()


def test_rms_norm_vs_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = (rng.standard_normal(64) * 0.1).astype(np.float32)
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)  # mean's sum order, rsqrt


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_kv_cache_append_vs_reference(dtype, per_slot):
    rng = np.random.default_rng(7)
    jc = jlayers.kv_cache_init(2, 6, 2, 8, dtype, per_slot=per_slot)
    tc = tlayers.kv_cache_init(2, 6, 2, 8, dtype, per_slot=per_slot)
    for s_new in (3, 1, 1, 1, 1):  # fills the cache and wraps the ring
        k = rng.standard_normal((2, s_new, 2, 8)).astype(np.float32)
        v = rng.standard_normal((2, s_new, 2, 8)).astype(np.float32)
        jc = jlayers.kv_append(jc, jnp.asarray(k), jnp.asarray(v))
        tc = tlayers.kv_append(tc, torch.from_numpy(k), torch.from_numpy(v))
        assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        assert np.array_equal(tc.length.numpy(), np.asarray(jc.length))
        assert np.array_equal(tc.k.to(torch.float32).numpy(), np.asarray(jc.k, np.float32))
        assert np.array_equal(tc.v.to(torch.float32).numpy(), np.asarray(jc.v, np.float32))
        if dtype == "int8":
            np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=1e-6)


def test_long_prefill_keeps_tail_like_reference():
    k = (np.arange(10, dtype=np.float32).reshape(1, 10, 1, 1) * np.ones((1, 10, 1, 2), np.float32))
    for per_slot in (False, True):
        jc = jlayers.kv_append(jlayers.kv_cache_init(1, 4, 1, 2, "bfloat16", per_slot=per_slot),
                               jnp.asarray(k), jnp.asarray(k))
        tc = tlayers.kv_append(tlayers.kv_cache_init(1, 4, 1, 2, "bfloat16", per_slot=per_slot),
                               torch.from_numpy(k), torch.from_numpy(k))
        assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        assert np.array_equal(tc.k.float().numpy(), np.asarray(jc.k, np.float32))
        assert int(tc.length.sum()) == 10


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("chunk", [4, 1024])
def test_flash_attention_vs_reference(window, chunk):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=4, kv_len=10, chunk=chunk)
    want = np.asarray(jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JPolicy(default=JMode.M24), **kw))
    got = tlayers.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        PrecisionPolicy(default=Mode.M24), **kw).numpy()
    assert got.shape == want.shape == (2, 6, 4, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODE_REL_ERROR[Mode.M24] * 4)
