"""Port vs reference, the Mamba-2 block (``repro_torch.models.ssm``) and the
causal depthwise conv (``models.layers.causal_conv1d``), on the CPU at the
smoke size of ``mamba2-2.7b`` (d_model 128, d_inner 256, 16 SSD heads of 16,
state 16, chunk 16).  Inputs are drawn by numpy from a seed and handed to
both packages.

Tolerances.  ``causal_conv1d`` sums its K taps in the reference's order:
bitwise.  The SSD algebra runs the same einsums through the same limb
algebra in both packages; they differ in the order f32 partial sums are
added inside a product and a cumulative sum (an ulp per step), so results
are held to the policy's ceiling (``MODE_REL_ERROR``) times ``FACTOR`` of
their scale, and never below ``SSD_TOL`` (the f32 ``exp``/``cumsum``
differences).  Within the port, the chunked dual
form and the per-token recurrence compute the same recurrence in two
association orders: ``FORMS_TOL``."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.policy import PRESETS as J_POLICIES
from repro.models import layers as jlayers
from repro.models import ssm as jssm

from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import PRESETS
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm

from test_torch_common import FACTOR, _gap

ARCH = "mamba2-2.7b"
#: port vs reference, over the result's scale (f32 summation order, exp)
SSD_TOL = 2e-5
#: chunked dual form vs per-token recurrence, within the port
FORMS_TOL = 2e-5


def _cfgs(policy: str):
    return (get_smoke_config(ARCH).with_policy(PRESETS[policy]),
            j_get_smoke_config(ARCH).with_policy(J_POLICIES[policy]))


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,k", [(1, 4), (7, 4), (16, 3), (5, 1)])
def test_causal_conv1d_bitwise(s, k, with_state):
    rng = np.random.default_rng(s * 10 + k)
    x, w = _np(rng, 2, s, 24), _np(rng, k, 24)
    st = _np(rng, 2, k - 1, 24) if with_state and k > 1 else None
    ty, tst = tlayers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                    None if st is None else torch.from_numpy(st))
    jy, jst = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    None if st is None else jnp.asarray(st))
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    if k > 1:
        assert np.array_equal(tst.numpy(), np.asarray(jst))
    else:
        assert tst is None and jst is None


def _ssd_inputs(cfg, rng, b=2, s=32):
    d_inner, h = tssm._dims(cfg)
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    return dict(xh=_np(rng, b, s, h, p), dt=np.abs(_np(rng, b, s, h, scale=0.5)) + 0.01,
                a=-np.exp(_np(rng, h, scale=0.5)), bmat=_np(rng, b, s, n, scale=0.5),
                cmat=_np(rng, b, s, n, scale=0.5), h0=_np(rng, b, h, p, n, scale=0.3))


def test_segsum_against_reference():
    x = _np(np.random.default_rng(0), 3, 4, 16)
    got = tssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    assert np.abs(got[finite] - want[finite]).max() <= SSD_TOL * np.abs(want[finite]).max()


@pytest.mark.parametrize("policy", ["native_f32", "paper_baseline"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_against_reference(policy, with_h0):
    tcfg, jcfg = _cfgs(policy)
    inp = _ssd_inputs(tcfg, np.random.default_rng(1))
    h0 = inp.pop("h0") if with_h0 else None
    inp.pop("h0", None)
    ty, tfin = tssm._ssd_chunked(*(torch.from_numpy(v) for v in inp.values()), tcfg,
                                 h0=None if h0 is None else torch.from_numpy(h0))
    jy, jfin = jssm._ssd_chunked(*(jnp.asarray(v) for v in inp.values()), jcfg,
                                 h0=None if h0 is None else jnp.asarray(h0))
    tol = max(SSD_TOL, FACTOR * _ceiling(policy))
    assert _gap(ty.numpy(), jy) <= tol
    assert _gap(tfin.numpy(), jfin) <= tol


def _ceiling(policy: str) -> float:
    from repro_torch.plan import MODE_REL_ERROR

    return MODE_REL_ERROR[PRESETS[policy].default]


def _mamba_params(cfg, seed=0):
    """One Mamba-2 block's parameters from numpy (the reference's tree)."""
    rng = np.random.default_rng(seed)
    d_inner, h = tssm._dims(cfg)
    n, d = cfg.ssm_state, cfg.d_model
    d_proj = 2 * d_inner + 2 * n + h
    tree = {"in_proj": {"w": _np(rng, d, d_proj, scale=(2 / (d + d_proj)) ** 0.5)},
            "conv_w": _np(rng, cfg.ssm_conv, d_inner + 2 * n, scale=0.2),
            "a_log": np.log(np.linspace(1, 16, h)).astype(np.float32),
            "dt_bias": _np(rng, h, scale=0.1), "d_skip": np.ones(h, np.float32),
            "norm_scale": _np(rng, d_inner, scale=0.05),
            "out_proj": {"w": _np(rng, d_inner, d, scale=(2 / (d_inner + d)) ** 0.5)}}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in t.items()}
    to_j = lambda t: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)
                      for k, v in t.items()}
    return to_t(tree), to_j(tree)


def _state_pair(cfg, rng, b):
    st = tssm.ssm_state_init(cfg, b)
    conv = _np(rng, *st.conv.shape, scale=0.5)
    ssm = _np(rng, *st.ssm.shape, scale=0.3)
    return (tssm.SSMState(torch.from_numpy(conv), torch.from_numpy(ssm)),
            jssm.SSMState(jnp.asarray(conv), jnp.asarray(ssm)))


@pytest.mark.parametrize("policy", ["native_f32", "paper_baseline"])
@pytest.mark.parametrize("branch,s", [("no_state", 32), ("chunked_h0", 32),
                                      ("recurrence", 1), ("recurrence", 20)])
def test_mamba2_apply_branches_against_reference(policy, branch, s):
    """All three branches of ``mamba2_apply``: no state (chunked), a state
    with ``s % min(chunk, s) == 0`` (chunked from ``h0``), and otherwise the
    per-token recurrence (s = 1, and s = 20 against chunk 16)."""
    tcfg, jcfg = _cfgs(policy)
    rng = np.random.default_rng(3)
    tp, jp = _mamba_params(tcfg)
    x = _np(rng, 2, s, tcfg.d_model)
    tst, jst = _state_pair(tcfg, rng, 2) if branch != "no_state" else (None, None)
    ty, tnew = tssm.mamba2_apply(tp, torch.from_numpy(x), tcfg, state=tst)
    jy, jnew = jssm.mamba2_apply(jp, jnp.asarray(x), jcfg, state=jst)
    tol = max(SSD_TOL, FACTOR * _ceiling(policy))
    assert _gap(ty.numpy(), jy) <= tol
    if branch == "no_state":
        assert tnew is None and jnew is None
    else:
        # the conv state is the projection's trailing rows: as close as it
        assert _gap(tnew.conv.numpy(), jnew.conv) <= tol
        assert _gap(tnew.ssm.numpy(), jnew.ssm) <= tol


@pytest.mark.parametrize("s", [16, 32])
def test_chunked_equals_sequential_within_the_port(s):
    """The chunked dual form from a carried state against feeding the same
    tokens one at a time (the per-token recurrence): outputs and final
    state."""
    cfg = get_smoke_config(ARCH).with_policy(PRESETS["native_f32"])
    rng = np.random.default_rng(4)
    tp, _ = _mamba_params(cfg, seed=1)
    x = torch.from_numpy(_np(rng, 2, s, cfg.d_model))
    st, _ = _state_pair(cfg, rng, 2)
    y_chunk, st_chunk = tssm.mamba2_apply(tp, x, cfg, state=st)
    ys, cur = [], st
    for t in range(s):
        y, cur = tssm.mamba2_apply(tp, x[:, t:t + 1], cfg, state=cur)
        ys.append(y)
    assert _gap(y_chunk.numpy(), torch.cat(ys, 1).numpy()) <= FORMS_TOL
    assert _gap(st_chunk.ssm.numpy(), cur.ssm.numpy()) <= FORMS_TOL
    assert torch.equal(st_chunk.conv, cur.conv)


def test_train_form_equals_decode_within_the_port():
    """``mamba2_apply`` without a state (training) against the decode
    recurrence from the zero state, token by token."""
    cfg = get_smoke_config(ARCH).with_policy(PRESETS["native_f32"])
    tp, _ = _mamba_params(cfg, seed=2)
    x = torch.from_numpy(_np(np.random.default_rng(5), 1, 32, cfg.d_model))
    y_train, _ = tssm.mamba2_apply(tp, x, cfg)
    cur = tssm.ssm_state_init(cfg, 1)
    ys = []
    for t in range(x.shape[1]):
        y, cur = tssm.mamba2_apply(tp, x[:, t:t + 1], cfg, state=cur)
        ys.append(y)
    assert _gap(y_train.numpy(), torch.cat(ys, 1).numpy()) <= FORMS_TOL


def test_init_and_state_shapes_match_the_reference():
    cfg = dataclasses.replace(get_smoke_config(ARCH))
    gen = torch.Generator().manual_seed(0)
    p = tssm.mamba2_init(gen, cfg, layers=3)
    d_inner, h = tssm._dims(cfg)
    assert tuple(p["in_proj"]["w"].shape) == (3, cfg.d_model, 2 * d_inner + 2 * cfg.ssm_state + h)
    assert tuple(p["conv_w"].shape) == (3, cfg.ssm_conv, d_inner + 2 * cfg.ssm_state)
    assert torch.equal(p["a_log"][2], torch.log(torch.linspace(1.0, 16.0, h)))
    st, jst = tssm.ssm_state_init(cfg, 2), jssm.ssm_state_init(j_get_smoke_config(ARCH), 2)
    assert tuple(st.conv.shape) == jst.conv.shape and tuple(st.ssm.shape) == jst.ssm.shape
