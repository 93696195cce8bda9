"""Port vs reference, the RG-LRU block of RecurrentGemma
(``repro_torch.models.griffin``), on the CPU at the smoke size of
``recurrentgemma-9b`` (d_model 128, lru width 128).  Inputs are drawn by
numpy from a seed and handed to both packages.

Tolerances.  The reference runs the recurrence ``h_t = a_t h_{t-1} + g_t``
as a ``jax.lax.associative_scan`` (a log-depth tree of products and sums);
the port runs it as a sequential f32 loop, the decode step's own update.
The two association orders round differently, by a few f32 ulps of the
state per step, so the scan is held to ``SCAN_TOL`` of its scale against
the reference, and bitwise against the port's own token-by-token steps.
The block's projections add the policy's ceiling (``MODE_REL_ERROR``) times
``FACTOR``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.policy import PRESETS as J_POLICIES
from repro.models import griffin as jgriffin

from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import PRESETS
from repro_torch.models import griffin as tgriffin
from repro_torch.plan import MODE_REL_ERROR

from test_torch_common import FACTOR, _gap

ARCH = "recurrentgemma-9b"
#: sequential loop vs the reference's associative scan, over the scale
SCAN_TOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _scan_inputs(rng, b=2, s=24, w=32):
    lin = np.linspace(0.9, 0.999, w)
    return dict(x=_np(rng, b, s, w), r=1 / (1 + np.exp(-_np(rng, b, s, w))),
                i=1 / (1 + np.exp(-_np(rng, b, s, w))),
                lam=np.log(lin / (1 - lin)).astype(np.float32), h0=_np(rng, b, w, scale=0.5))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 7, 24])
def test_rglru_scan_against_reference(s, with_h0):
    inp = _scan_inputs(np.random.default_rng(s), s=s)
    h0 = inp.pop("h0") if with_h0 else None
    inp.pop("h0", None)
    args = [v.astype(np.float32) for v in inp.values()]
    th, tlast = tgriffin._rglru_scan(*(torch.from_numpy(v) for v in args),
                                     None if h0 is None else torch.from_numpy(h0))
    jh, jlast = jgriffin._rglru_scan(*(jnp.asarray(v) for v in args),
                                     None if h0 is None else jnp.asarray(h0))
    assert _gap(th.numpy(), jh) <= SCAN_TOL
    assert _gap(tlast.numpy(), jlast) <= SCAN_TOL


def test_rglru_scan_equals_its_own_step_loop():
    """The scan over a sequence against one call per token carrying the
    state (the decode path): the same f32 updates, bit for bit."""
    inp = _scan_inputs(np.random.default_rng(9), s=16)
    x, r, i, lam, h0 = (torch.from_numpy(v.astype(np.float32)) for v in inp.values())
    hs, last = tgriffin._rglru_scan(x, r, i, lam, h0)
    h = h0
    for t in range(x.shape[1]):
        step, h = tgriffin._rglru_scan(x[:, t:t + 1], r[:, t:t + 1], i[:, t:t + 1], lam, h)
        assert torch.equal(step[:, 0], hs[:, t])
    assert torch.equal(h, last)
    # and from no state against the zero state
    hz, _ = tgriffin._rglru_scan(x, r, i, lam, None)
    hz0, _ = tgriffin._rglru_scan(x, r, i, lam, torch.zeros_like(h0))
    assert torch.equal(hz, hz0)


def _rglru_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d = w = cfg.d_model
    lin = np.linspace(0.9, 0.999, w)
    xav = (2 / (d + w)) ** 0.5
    tree = {"in_x": {"w": _np(rng, d, w, scale=xav)}, "in_gate": {"w": _np(rng, d, w, scale=xav)},
            "conv_w": _np(rng, 4, w, scale=0.2), "wa": {"w": _np(rng, w, w, scale=0.02)},
            "wx": {"w": _np(rng, w, w, scale=0.02)},
            "lam": np.log(lin / (1 - lin)).astype(np.float32),
            "out": {"w": _np(rng, w, d, scale=xav)}}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in t.items()}
    to_j = lambda t: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)
                      for k, v in t.items()}
    return to_t(tree), to_j(tree)


@pytest.mark.parametrize("policy", ["native_f32", "paper_baseline", "fast_m8"])
@pytest.mark.parametrize("with_state,s", [(False, 12), (True, 1), (True, 12)])
def test_rglru_block_against_reference(policy, with_state, s):
    tcfg = get_smoke_config(ARCH).with_policy(PRESETS[policy])
    jcfg = j_get_smoke_config(ARCH).with_policy(J_POLICIES[policy])
    rng = np.random.default_rng(5)
    tp, jp = _rglru_params(tcfg)
    x = _np(rng, 2, s, tcfg.d_model)
    tst = jst = None
    if with_state:
        conv, h = _np(rng, 2, 3, tcfg.d_model, scale=0.5), _np(rng, 2, tcfg.d_model, scale=0.5)
        tst = tgriffin.RGLRUState(torch.from_numpy(conv), torch.from_numpy(h))
        jst = jgriffin.RGLRUState(jnp.asarray(conv), jnp.asarray(h))
    ty, tnew = tgriffin.rglru_block_apply(tp, torch.from_numpy(x), tcfg, state=tst)
    jy, jnew = jgriffin.rglru_block_apply(jp, jnp.asarray(x), jcfg, state=jst)
    tol = max(SCAN_TOL, MODE_REL_ERROR[PRESETS[policy].default] * FACTOR)
    assert _gap(ty.numpy(), jy) <= tol
    if with_state:
        assert _gap(tnew.h.numpy(), jnew.h) <= tol
        assert _gap(tnew.conv.numpy(), jnew.conv) <= tol
    else:
        assert tnew is None and jnew is None


def test_init_and_state_shapes_match_the_reference():
    cfg = get_smoke_config(ARCH)
    p = tgriffin.rglru_init(torch.Generator().manual_seed(0), cfg, layers=2)
    assert tuple(p["wa"]["w"].shape) == (2, cfg.d_model, cfg.d_model)
    assert tuple(p["conv_w"].shape) == (2, 4, cfg.d_model)
    a = torch.sigmoid(p["lam"][1])
    assert float(a.min()) == pytest.approx(0.9, rel=1e-5)
    assert float(a.max()) == pytest.approx(0.999, rel=1e-5)
    st = tgriffin.rglru_state_init(cfg, 3)
    jst = jgriffin.rglru_state_init(j_get_smoke_config(ARCH), 3)
    assert tuple(st.conv.shape) == jst.conv.shape and tuple(st.h.shape) == jst.h.shape
