"""Port vs reference: the RMPM engine (``core.rmpm``), Strassen and the
planner.  The same numpy operands go through ``repro`` and ``repro_torch``
(``device="cpu"``, so the port's kernels run as their plain versions; the
reference's Pallas kernels run in interpret mode where a test reaches them).

Tolerances.  Two limb products of the same operands differ only in the order
their f32 partial sums are added, so port and reference agree to ``2e-6`` of
the result scale (the bound the reference holds its own kernels to).  Against
float64 each mode is held to its README ladder ceiling ``MODE_REL_ERROR``."""
import dataclasses
import doctest

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import rmpm as jrmpm
from repro.core.precision import DoubleF32 as JDoubleF32
from repro.core.precision import Mode as JMode
from repro.plan import cost as jcost
from repro.plan import plan_matmul as j_plan_matmul
from repro.plan import plan_model_policy as j_plan_model_policy
from repro.configs import get_smoke_config as j_get_smoke_config

from repro_torch.configs import get_smoke_config
from repro_torch.core import rmpm, strassen
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.precision import DoubleF32, Mode, df32_from_f64
from repro_torch.kernels import build
from repro_torch.plan import (
    DEFAULT_BALANCE,
    MODE_REL_ERROR,
    MachineBalance,
    clear_plan_cache,
    execute,
    matmul,
    plan_cache_stats,
    plan_matmul,
    plan_model_policy,
)
from repro_torch.plan import planner as planner_mod

SUM_ORDER_TOL = 2e-6
F32_LADDER = (Mode.M8, Mode.M16, Mode.M24)


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _ab(rng, m, k, n):
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _f64(a, b):
    return a.astype(np.float64) @ b.astype(np.float64)


# ---------------------------------------------------------------------------
# core.rmpm
# ---------------------------------------------------------------------------


class TestStaticModes:
    @pytest.mark.parametrize("mode", F32_LADDER)
    @pytest.mark.parametrize("impl", ["xla", "pallas", "tile", "native"])
    def test_mp_matmul_vs_reference(self, rng, mode, impl):
        a, b = _ab(rng, 48, 160, 40)
        got = rmpm.mp_matmul(_t(a), _t(b), mode, impl=impl, device="cpu").numpy()
        # the reference's 'pallas'/'tile' run their kernels in interpret mode
        want = np.asarray(jrmpm.mp_matmul(jnp.asarray(a), jnp.asarray(b),
                                          JMode(int(mode)), impl=impl))
        assert _rel(got, want) <= SUM_ORDER_TOL
        ceiling = MODE_REL_ERROR[Mode.M24 if impl == "native" else mode]
        assert _rel(got, _f64(a, b)) <= ceiling

    def test_ladder_error_falls_with_mode(self, rng):
        a, b = _ab(rng, 64, 256, 64)
        errs = [_rel(rmpm.mp_matmul(_t(a), _t(b), m, device="cpu").numpy(), _f64(a, b))
                for m in F32_LADDER]
        assert errs[0] > errs[1] > errs[2]

    @pytest.mark.parametrize("mode", [Mode.M32, Mode.M48])
    def test_df32_modes_vs_reference_and_f64(self, rng, mode):
        a64 = rng.standard_normal((12, 40))
        b64 = rng.standard_normal((40, 10))
        ta, tb = df32_from_f64(_t(a64)), df32_from_f64(_t(b64))
        got = rmpm.mp_matmul(ta, tb, mode, device="cpu")
        assert isinstance(got, DoubleF32)
        ja = JDoubleF32(jnp.asarray(ta.hi.numpy()), jnp.asarray(ta.lo.numpy()))
        jb = JDoubleF32(jnp.asarray(tb.hi.numpy()), jnp.asarray(tb.lo.numpy()))
        want = jrmpm.mp_matmul(ja, jb, JMode(int(mode)))
        # the same TwoSum cascade in the same order: the pairs agree bit for bit
        assert np.array_equal(got.hi.numpy(), np.asarray(want.hi))
        assert np.array_equal(got.lo.numpy(), np.asarray(want.lo))
        total = got.hi.numpy().astype(np.float64) + got.lo.numpy().astype(np.float64)
        assert _rel(total, a64 @ b64) <= MODE_REL_ERROR[mode]

    def test_f32_mode_rejects_doublef32(self, rng):
        a64 = rng.standard_normal((4, 8))
        with pytest.raises(ValueError, match="DoubleF32 operands need M32/M48"):
            rmpm.mp_einsum("mk,kn->mn", df32_from_f64(_t(a64)), _t(a64.T.astype(np.float32)),
                           Mode.M16, device="cpu")

    @pytest.mark.parametrize("mode", F32_LADDER)
    @pytest.mark.parametrize("eq,sa,sb", [
        ("bqhgd,bkhd->bhgqk", (2, 5, 2, 2, 16), (2, 7, 2, 16)),
        ("bhgqk,bkhd->bhgqd", (2, 2, 2, 5, 7), (2, 7, 2, 16)),
        ("bsd,dv->bsv", (2, 3, 32), (32, 50)),
        ("bsd,vd->bsv", (2, 3, 32), (50, 32)),
    ])
    def test_mp_einsum_vs_reference(self, rng, mode, eq, sa, sb):
        a = rng.standard_normal(sa).astype(np.float32)
        b = rng.standard_normal(sb).astype(np.float32)
        got = rmpm.mp_einsum(eq, _t(a), _t(b), mode, device="cpu").numpy()
        want = np.asarray(jrmpm.mp_einsum(eq, jnp.asarray(a), jnp.asarray(b), JMode(int(mode))))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert _rel(got, want) <= SUM_ORDER_TOL
        assert _rel(got, np.einsum(eq, a.astype(np.float64), b.astype(np.float64))) \
            <= MODE_REL_ERROR[mode]

    @pytest.mark.parametrize("rounding", ["grte", "trunc"])
    def test_rounding_vs_reference(self, rng, rounding):
        a, b = _ab(rng, 16, 64, 24)
        got = rmpm.mp_matmul(_t(a), _t(b), Mode.M16, rounding=rounding, device="cpu").numpy()
        want = np.asarray(jrmpm.mp_matmul(jnp.asarray(a), jnp.asarray(b), JMode.M16,
                                          rounding=rounding))
        assert _rel(got, want) <= SUM_ORDER_TOL

    def test_batched_lhs_and_linear(self, rng):
        a = rng.standard_normal((2, 3, 48)).astype(np.float32)
        b = rng.standard_normal((48, 24)).astype(np.float32)
        bias = rng.standard_normal((24,)).astype(np.float32)
        got = rmpm.mp_linear(_t(a), _t(b), _t(bias), Mode.M24, device="cpu").numpy()
        want = np.asarray(jrmpm.mp_linear(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                                          JMode.M24))
        assert got.shape == (2, 3, 24)
        assert _rel(got, want) <= SUM_ORDER_TOL

    def test_default_device_is_the_gpu_or_an_error(self, rng):
        a, b = _ab(rng, 4, 8, 4)
        if torch.cuda.is_available():
            assert rmpm.mp_matmul(_t(a), _t(b)).is_cuda
        else:
            with pytest.raises(RuntimeError, match="found no GPU"):
                rmpm.mp_matmul(_t(a), _t(b))
            with pytest.raises(RuntimeError, match="found none"):
                plan_matmul((4, 8), (8, 4))


class TestRuntimeModes:
    @pytest.mark.parametrize("impl", ["xla", "pallas", "tile"])
    @pytest.mark.parametrize("mode", F32_LADDER)
    def test_runtime_equals_static_bitwise(self, rng, impl, mode):
        a, b = _ab(rng, 24, 96, 40)
        static = rmpm.mp_matmul(_t(a), _t(b), mode, impl=impl, device="cpu")
        for scalar in (int(mode), torch.tensor(int(mode), dtype=torch.int32)):
            got = rmpm.mp_matmul_runtime(_t(a), _t(b), scalar, impl=impl, device="cpu")
            assert torch.equal(got, static)
        want = np.asarray(jrmpm.mp_matmul_runtime(jnp.asarray(a), jnp.asarray(b),
                                                  jnp.int32(int(mode)), impl=impl))
        assert _rel(got.numpy(), want) <= SUM_ORDER_TOL

    def test_tile_equals_pallas_bitwise_at_every_mode(self, rng):
        a, b = _ab(rng, 40, 200, 72)
        for mode in F32_LADDER:
            assert torch.equal(
                rmpm.mp_matmul_runtime(_t(a), _t(b), int(mode), impl="tile", device="cpu"),
                rmpm.mp_matmul(_t(a), _t(b), mode, impl="pallas", device="cpu"))
        assert build.BUILD_COUNT == 0  # CPU tensors never build or launch

    @pytest.mark.parametrize("case,expect", [("integers", Mode.M8), ("full", Mode.M24)])
    def test_auto_mode_selection_vs_reference(self, rng, case, expect):
        a, b = _ab(rng, 16, 32, 8)
        if case == "integers":
            a, b = np.round(a * 4), np.round(b * 4)
        got = rmpm.mp_matmul_runtime(_t(a), _t(b), Mode.AUTO, device="cpu")
        assert torch.equal(got, rmpm.mp_matmul(_t(a), _t(b), expect, device="cpu"))
        want = np.asarray(jrmpm.mp_matmul_runtime(jnp.asarray(a), jnp.asarray(b), JMode.AUTO))
        assert _rel(got.numpy(), want) <= SUM_ORDER_TOL

    @pytest.mark.parametrize("mode", F32_LADDER)
    def test_einsum_runtime_vs_reference(self, rng, mode):
        a = rng.standard_normal((2, 3, 32)).astype(np.float32)
        b = rng.standard_normal((32, 50)).astype(np.float32)
        got = rmpm.mp_einsum_runtime("bsd,dv->bsv", _t(a), _t(b), int(mode),
                                     impl="tile", device="cpu")
        assert torch.equal(got, rmpm.mp_einsum("bsd,dv->bsv", _t(a), _t(b), mode, device="cpu"))
        want = np.asarray(jrmpm.mp_einsum_runtime("bsd,dv->bsv", jnp.asarray(a), jnp.asarray(b),
                                                  jnp.int32(int(mode))))
        assert _rel(got.numpy(), want) <= SUM_ORDER_TOL

    def test_einsum_runtime_rejects_native(self, rng):
        a, b = _ab(rng, 4, 8, 4)
        with pytest.raises(ValueError, match="impl='native' ignores the mode"):
            rmpm.mp_einsum_runtime("mk,kn->mn", _t(a), _t(b), 2, impl="native", device="cpu")

    @pytest.mark.parametrize("mode", [Mode.M32, Mode.M48])
    def test_runtime_df32_switch(self, rng, mode):
        a64, b64 = rng.standard_normal((6, 20)), rng.standard_normal((20, 5))
        ta, tb = df32_from_f64(_t(a64)), df32_from_f64(_t(b64))
        got = rmpm.mp_matmul_runtime_df32(ta, tb, int(mode), device="cpu")
        want = rmpm.mp_matmul(ta, tb, mode, device="cpu")
        assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


# ---------------------------------------------------------------------------
# core.strassen
# ---------------------------------------------------------------------------


class TestStrassen:
    @pytest.mark.parametrize("depth", [1, 2])
    def test_matches_classical_and_reference(self, rng, depth):
        from repro.core import strassen as jstrassen

        a, b = _ab(rng, 128, 128, 128)
        got = strassen.strassen_matmul(_t(a), _t(b), depth=depth, align=16).numpy()
        assert _rel(got, _f64(a, b)) < MODE_REL_ERROR[Mode.M24] * 2**depth
        want = np.asarray(jstrassen.strassen_matmul(jnp.asarray(a), jnp.asarray(b),
                                                    depth=depth, align=16))
        # the same seven products recombined in the same order; only the leaf
        # products' inner summation order differs between the frameworks
        assert _rel(got, want) <= 1e-5

    @pytest.mark.parametrize("m,k,n", [(70, 33, 50), (1, 17, 5), (129, 65, 31)])
    def test_arbitrary_shapes_padded(self, rng, m, k, n):
        a, b = _ab(rng, m, k, n)
        got = strassen.strassen_matmul(_t(a), _t(b), depth=2, align=8).numpy()
        assert got.shape == (m, n)
        assert _rel(got, _f64(a, b)) < 1e-5

    def test_rmpm_leaf_through_mp_matmul(self, rng):
        a, b = _ab(rng, 64, 64, 64)
        got = rmpm.mp_matmul(_t(a), _t(b), Mode.M16, strassen_depth=1, device="cpu").numpy()
        assert _rel(got, _f64(a, b)) < MODE_REL_ERROR[Mode.M16] * 8

    def test_economy_counts_equal_reference(self):
        from repro.core import strassen as jstrassen

        for depth in (0, 1, 2, 3):
            assert strassen.leaf_products(depth) == jstrassen.leaf_products(depth) == 7**depth
            assert strassen.flops_ratio(depth) == jstrassen.flops_ratio(depth)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

#: the reference's machine constants, handed to the port explicitly so that
#: the two planners rank the same candidates on the same roofline
REFERENCE_BALANCE = MachineBalance(
    peak_flops=jcost.PEAK_FLOPS, hbm_bw=jcost.HBM_BW, f32_flops=None,
    source="reference constants")

PLAN_CASES = [
    ((4096, 4096), (4096, 4096), dict(accuracy=2**-12)),
    ((256, 256), (256, 256), dict(accuracy=2**-4)),
    ((1024, 1024), (1024, 1024), dict(accuracy=None)),
    ((512, 512), (512, 512), dict(accuracy=2**-30, dtype="df32")),
    ((8, 16), (16, 8), dict(accuracy=2**-12)),
    ((4, 1024), (1024, 2816), dict(accuracy=2**-12, max_depth=0)),
    ((3, 96, 1024), (1024, 1024), dict(mode=2, impl="tile")),
    ((16384, 16384), (16384, 16384), dict(accuracy=2**-12, max_depth=3)),
    ((512, 512), (512, 512), dict(accuracy=2**-12, rounding="grte")),
    ((256, 256), (256, 256), dict(accuracy=2**-10, map_source="magnitude")),
]


class TestPlanSelection:
    @pytest.mark.parametrize("shape_a,shape_b,kw", PLAN_CASES)
    def test_tpu_backend_selection_equals_reference(self, shape_a, shape_b, kw):
        want = j_plan_matmul(shape_a, shape_b, backend="tpu", tune_table=False, **kw)
        got = plan_matmul(shape_a, shape_b, backend="tpu", balance=REFERENCE_BALANCE, **kw)
        assert (int(got.mode), got.impl, got.strassen_depth, got.dtype, got.map_source) == (
            int(want.mode), want.impl, want.strassen_depth, want.dtype, want.map_source)
        assert got.cost.flops == pytest.approx(want.cost.flops)
        assert got.cost.hbm_bytes == pytest.approx(want.cost.hbm_bytes)
        assert got.cost.t_total_s == pytest.approx(want.cost.t_total_s)
        assert got.tile_eligible == want.tile_eligible

    def test_gpu_backend_offers_the_kernels_and_defaults_are_datasheet(self):
        p = plan_matmul((4096, 4096), (4096, 4096), accuracy=2**-12, backend="gpu")
        assert (p.mode, p.impl) == (Mode.M16, "pallas") and p.tile_eligible
        assert "H100 SXM data sheet" in p.reason
        assert (DEFAULT_BALANCE.peak_flops, DEFAULT_BALANCE.hbm_bw,
                DEFAULT_BALANCE.f32_flops) == (989e12, 3.35e12, 67e12)
        # the CPU has no hand-written kernel: never a candidate there
        c = plan_matmul((4096, 4096), (4096, 4096), accuracy=2**-12, backend="cpu")
        assert c.impl in ("xla", "native") and not c.tile_eligible

    def test_native_is_charged_at_the_f32_rate(self):
        # compute-bound and f32-accurate: 6 bf16 passes at the tensor-core
        # rate beat one f32 pass at the f32 rate, so the multiplier wins
        p = plan_matmul((8192, 8192), (8192, 8192), accuracy=2**-20, backend="gpu",
                        max_depth=0)
        assert p.mode == Mode.M24 and p.impl == "pallas"
        flat = MachineBalance(f32_flops=None, source="no separate f32 rate")
        q = plan_matmul((8192, 8192), (8192, 8192), accuracy=2**-20, backend="gpu",
                        max_depth=0, balance=flat)
        assert q.impl == "native"

    def test_accuracy_ladder_monotone(self):
        modes = [plan_matmul((256, 256), (256, 256), accuracy=acc, backend="gpu").mode
                 for acc in (2**-4, 2**-12, 2**-20)]
        assert modes == [Mode.M8, Mode.M16, Mode.M24]

    @pytest.mark.parametrize("kw,match", [
        (dict(mode=Mode.AUTO), "AUTO"),
        (dict(impl="cublas"), "unknown impl"),
        (dict(dtype="float64"), "unknown dtype"),
        (dict(map_source="random"), "unknown map_source"),
        (dict(map_source="magnitude"), "needs an accuracy budget"),
        (dict(map_source="magnitude", impl="xla", accuracy=1e-3), "requires impl='tile'"),
        (dict(mode=Mode.M16, dtype="df32"), "DoubleF32 operands need M32/M48"),
    ])
    def test_validation_errors(self, kw, match):
        with pytest.raises(ValueError, match=match):
            plan_matmul((64, 64), (64, 64), backend="cpu", **kw)

    def test_shape_errors(self):
        with pytest.raises(ValueError, match="mismatch"):
            plan_matmul((64, 32), (64, 64), backend="cpu")
        with pytest.raises(ValueError, match="need A"):
            plan_matmul((64,), (64, 64), backend="cpu")

    @pytest.mark.parametrize("table", ["tuning/cpu.json", object()])
    def test_tune_table_waits_for_the_tuner(self, table):
        # the tuner is ported: a table path plans from the measurements,
        # anything that is no table is refused
        if isinstance(table, str):
            p = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu",
                            tune_table=table)
            assert p.source == "measured" and "(table " in p.reason
        else:
            with pytest.raises(TypeError, match="tune_table must be"):
                plan_matmul((64, 64), (64, 64), backend="cpu", tune_table=table)
        assert plan_matmul((64, 64), (64, 64), backend="cpu", tune_table=False).impl == "xla"

    def test_doctest(self):
        results = doctest.testmod(planner_mod, verbose=False)
        assert results.attempted >= 2 and results.failed == 0


class TestPlanCache:
    def test_hit_returns_same_object(self):
        p1 = plan_matmul((128, 128), (128, 128), accuracy=2**-12, backend="gpu")
        assert (plan_cache_stats().hits, plan_cache_stats().misses) == (0, 1)
        assert plan_matmul((128, 128), (128, 128), accuracy=2**-12, backend="gpu") is p1
        assert (plan_cache_stats().hits, plan_cache_stats().misses) == (1, 1)

    def test_distinct_keys_miss_and_clear(self):
        plan_matmul((128, 128), (128, 128), accuracy=2**-12, backend="gpu")
        plan_matmul((128, 128), (128, 128), accuracy=2**-4, backend="gpu")
        plan_matmul((128, 256), (256, 128), accuracy=2**-12, backend="gpu")
        plan_matmul((128, 128), (128, 128), accuracy=2**-12, backend="cpu")
        s = plan_cache_stats()
        assert (s.hits, s.misses, s.entries) == (0, 4, 4)
        clear_plan_cache()
        assert (s.hits, s.misses, s.entries) == (0, 0, 0)

    def test_layer_loop_plans_each_gemm_once(self, rng):
        from repro_torch.models.layers import pmm

        x = _t(rng.standard_normal((8, 64)).astype(np.float32))
        w = _t(rng.standard_normal((64, 64)).astype(np.float32))
        for _ in range(5):
            x = pmm(x, w, "mlp_up", PrecisionPolicy())
        s = plan_cache_stats()
        assert s.misses == 1 and s.hits == 4


class TestExecution:
    @pytest.mark.parametrize("m,k,n", [(300, 270, 130), (1, 17, 5), (33, 470, 31)])
    def test_strassen_plan_matches_f64(self, rng, m, k, n):
        a, b = _ab(rng, m, k, n)
        p = plan_matmul((m, k), (k, n), mode=Mode.M16, impl="xla", max_depth=2, align=16,
                        backend="cpu")
        p = dataclasses.replace(p, strassen_depth=2)
        assert _rel(execute(p, _t(a), _t(b)).numpy(), _f64(a, b)) < MODE_REL_ERROR[Mode.M16] * 8

    @pytest.mark.parametrize("impl", ["xla", "pallas", "tile", "native"])
    def test_execute_equals_engine_and_reference(self, rng, impl):
        a, b = _ab(rng, 40, 96, 56)
        p = plan_matmul((40, 96), (96, 56), mode=None if impl == "native" else Mode.M16,
                        impl=impl, backend="cpu")
        got = execute(p, _t(a), _t(b))
        assert torch.equal(got, rmpm.mp_matmul(_t(a), _t(b), p.mode, impl=impl, device="cpu"))
        jp = j_plan_matmul((40, 96), (96, 56), mode=None if impl == "native" else JMode.M16,
                           impl=impl, backend="cpu", tune_table=False)
        from repro.plan import execute as j_execute

        want = np.asarray(j_execute(jp, jnp.asarray(a), jnp.asarray(b)))
        assert _rel(got.numpy(), want) <= SUM_ORDER_TOL

    def test_batched_leading_dims(self, rng):
        a = rng.standard_normal((3, 2, 64, 64)).astype(np.float32)
        b = rng.standard_normal((64, 64)).astype(np.float32)
        p = plan_matmul(a.shape, b.shape, mode=Mode.M24, impl="xla", max_depth=1, align=16,
                        backend="cpu")
        p = dataclasses.replace(p, strassen_depth=1)
        out = execute(p, _t(a), _t(b))
        assert tuple(out.shape) == (3, 2, 64, 64)
        ref = np.einsum("btmk,kn->btmn", a.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)

    def test_magnitude_plan_runs_the_tile_path(self, rng):
        a, b = _ab(rng, 64, 128, 64)
        a[:32] *= 50.0
        got = matmul(_t(a), _t(b), accuracy=2.0**-12, map_source="magnitude", device="cpu")
        envelope = np.abs(a).max() * np.abs(b).max() * 128
        assert np.abs(got.numpy() - _f64(a, b)).max() <= 2.0**-12 * envelope

    def test_matmul_convenience_df32(self, rng):
        a64, b64 = rng.standard_normal((24, 64)), rng.standard_normal((64, 16))
        out = matmul(df32_from_f64(_t(a64)), df32_from_f64(_t(b64)), accuracy=2**-28,
                     device="cpu")
        assert isinstance(out, DoubleF32)
        total = out.hi.numpy().astype(np.float64) + out.lo.numpy().astype(np.float64)
        assert _rel(total, a64 @ b64) < 2**-28

    def test_execute_rejects_wrong_shapes(self, rng):
        a, b = _ab(rng, 32, 32, 32)
        p = plan_matmul((64, 32), (32, 32), backend="cpu")
        with pytest.raises(ValueError, match="do not match plan"):
            execute(p, _t(a), _t(b))


class TestPolicyBridge:
    @pytest.mark.parametrize("accuracy", [2**-4, 2**-12, 2**-20])
    @pytest.mark.parametrize("tokens", [4, 1024])
    def test_plan_model_policy_equals_reference(self, accuracy, tokens):
        cfg = get_smoke_config("qwen1.5-0.5b")
        jcfg = j_get_smoke_config("qwen1.5-0.5b")
        policy, plans = plan_model_policy(cfg, tokens=tokens, accuracy=accuracy,
                                          backend="tpu", balance=REFERENCE_BALANCE)
        jpolicy, jplans = j_plan_model_policy(jcfg, tokens=tokens, accuracy=accuracy,
                                              backend="tpu", tune_table=False)
        assert set(plans) == set(jplans)
        for op in plans:
            assert (int(plans[op].mode), plans[op].impl, plans[op].shape_a, plans[op].shape_b) == (
                int(jplans[op].mode), jplans[op].impl, jplans[op].shape_a, jplans[op].shape_b), op
        assert int(policy.default) == int(jpolicy.default) and policy.impl == jpolicy.impl
        assert [(op, int(m)) for op, m in policy.overrides] == [
            (op, int(m)) for op, m in jpolicy.overrides]
        for op in plans:
            assert int(policy.mode_for(op)) == int(jpolicy.mode_for(op))

    def test_sensitive_ops_planned_tighter(self):
        cfg = get_smoke_config("qwen1.5-0.5b")
        policy, plans = plan_model_policy(cfg, tokens=8 * 128, accuracy=2**-4, backend="gpu")
        assert policy.default == Mode.M8
        assert policy.mode_for("logits").value > Mode.M8.value
        assert "mlp_up" in plans and plans["mlp_up"].impl in ("xla", "pallas", "native")
