"""Port vs reference, the four kernel modules.  The JAX wrappers run their
Pallas kernels in interpret mode; the port's wrappers get CPU tensors and so
run their plain PyTorch versions (the CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``).

Tolerances: matmuls 2e-6 of the result scale — the bound the reference holds
its own kernels to (K-tiling reorders the f32 accumulation); the double-f32
kernel 2^-22 of the result scale against an f64 product (the reference's
bound, ``tests/test_kernels.py``) with |lo| < 2^-20 max|hi|, and the two
packages' (hi + lo) within 2^-22 of each other (each sums a slab's products
in its own order: measured gap about 1e-7 of scale); quantize and every
in-port identity bitwise."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.limb_matmul.limb_matmul import limb_matmul_dd_pallas as j_limb_matmul_dd
from repro.kernels.limb_matmul.ops import limb_matmul as j_limb_matmul
from repro.kernels.quantize_mantissa.ops import quantize_mantissa_op as j_quant_op
from repro.kernels.tile_matmul import ops as j_tile
from repro.kernels.tile_matmul.tile_policy import magnitude_map as j_magnitude_map

from repro_torch.core.precision import F32_MODES, MODE_LIMBS, Mode
from repro_torch.kernels import build
from repro_torch.kernels.limb_matmul import ops as limb_ops
from repro_torch.kernels.limb_matmul.ops import (
    limb_matmul,
    limb_matmul_dd,
    k_step,
    limb_matmul_dd_plain,
    limb_matmul_plain,
)
from repro_torch.kernels.limb_matmul.ref import limb_matmul_ref
from repro_torch.kernels.quantize_mantissa.ops import quantize_mantissa_op
from repro_torch.kernels.quantize_mantissa.ref import quantize_mantissa_ref
from repro_torch.kernels.tile_matmul.ops import (
    tile_grid,
    tile_matmul,
    tile_matmul_auto,
    tile_matmul_mode,
    tile_matmul_runtime,
)
from repro_torch.kernels.tile_matmul.ref import tile_matmul_ref
from repro_torch.kernels.tile_matmul.tile_policy import (
    magnitude_map,
    table_map,
    uniform_map,
)

BLK = dict(bm=32, bn=32, bk=64)
TOL = 2e-6
DD_F64_TOL = 2.0**-22
DD_LO_RATIO = 2.0**-20


def _ab(rng, m, kd, n):
    return (rng.standard_normal((m, kd)).astype(np.float32),
            rng.standard_normal((kd, n)).astype(np.float32))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestQuantizeMantissa:
    @pytest.mark.parametrize("rounding", ["trunc", "rne", "grte"])
    @pytest.mark.parametrize("keep", [1, 5, 7, 15, 20, 22])
    def test_bit_exact_vs_reference_kernel_and_oracle(self, rng, rounding, keep):
        x = (rng.standard_normal((57, 131)) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
        got = quantize_mantissa_op(_t(x), keep, rounding).numpy()
        want = np.asarray(j_quant_op(jnp.asarray(x), keep, rounding, interpret=True))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.array_equal(got, quantize_mantissa_ref(x, keep, rounding))

    def test_nd_shapes_and_specials(self, rng):
        x = rng.standard_normal((3, 5, 7, 11)).astype(np.float32)
        got = quantize_mantissa_op(_t(x), 7, "grte").numpy()
        assert got.shape == x.shape
        assert np.array_equal(got, quantize_mantissa_ref(x, 7, "grte").reshape(x.shape))
        sp = np.array([np.inf, -np.inf, np.nan, 0.0], np.float32)
        out = quantize_mantissa_op(_t(sp), 7, "grte").numpy()
        assert np.isinf(out[0]) and np.isinf(out[1]) and np.isnan(out[2]) and out[3] == 0

    @pytest.mark.parametrize("keep", [0, -1, -8])
    def test_nonpositive_keep_rejected(self, keep):
        with pytest.raises(ValueError, match="keep must be >= 1"):
            quantize_mantissa_op(torch.zeros(8, 8), keep, "grte")

    def test_identity_at_full_width(self, rng):
        x = _t(rng.standard_normal((4, 4)).astype(np.float32))
        assert quantize_mantissa_op(x, 23, "grte") is x


class TestLimbMatmul:
    @pytest.mark.parametrize("k", [1, 2, 3])
    @pytest.mark.parametrize(
        "m,kd,n", [(32, 64, 32), (100, 300, 70), (17, 33, 9), (128, 128, 128)])
    def test_vs_reference_kernel_and_oracle(self, rng, k, m, kd, n):
        a, b = _ab(rng, m, kd, n)
        got = limb_matmul(_t(a), _t(b), k, **BLK).numpy()
        want = np.asarray(j_limb_matmul(jnp.asarray(a), jnp.asarray(b), k,
                                        interpret=True, **BLK))
        _close(got, want)
        _close(got, limb_matmul_ref(_t(a), _t(b), k).numpy())

    def test_bf16_inputs(self, rng):
        a, b = _ab(rng, 64, 64, 64)
        ta, tb = _t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16)
        got = limb_matmul(ta, tb, 2, bm=32, bn=32, bk=32).numpy()
        want = np.asarray(j_limb_matmul(
            jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
            2, interpret=True, bm=32, bn=32, bk=32))
        _close(got, want)

    def test_batched_lhs(self, rng):
        a = rng.standard_normal((2, 3, 48)).astype(np.float32)
        b = rng.standard_normal((48, 24)).astype(np.float32)
        got = limb_matmul(_t(a), _t(b), 3, bm=8, bn=8, bk=16)
        assert tuple(got.shape) == (2, 3, 24)
        want = np.asarray(j_limb_matmul(jnp.asarray(a), jnp.asarray(b), 3,
                                        interpret=True, bm=8, bn=8, bk=16))
        _close(got.numpy(), want)

    @pytest.mark.parametrize("rounding", ["grte", "trunc"])
    def test_rounded_inputs(self, rng, rounding):
        a, b = _ab(rng, 32, 32, 32)
        got = limb_matmul(_t(a), _t(b), 2, rounding=rounding, bm=16, bn=16, bk=16).numpy()
        want = np.asarray(j_limb_matmul(jnp.asarray(a), jnp.asarray(b), 2,
                                        rounding=rounding, interpret=True,
                                        bm=16, bn=16, bk=16))
        _close(got, want)
        rel = np.abs(got - a @ b).max() / np.abs(a @ b).max()
        assert rel < 2**-13

    def test_mode_error_ladder_strictly_falls(self, rng):
        a, b = _ab(rng, 64, 128, 64)
        ref = a.astype(np.float64) @ b.astype(np.float64)
        errs = [np.abs(limb_matmul(_t(a), _t(b), k, **BLK).numpy().astype(np.float64)
                       - ref).max() / np.abs(ref).max() for k in (1, 2, 3)]
        assert errs[0] > errs[1] > errs[2]

    def test_cpu_tensors_launch_nothing(self, rng):
        a, b = _ab(rng, 8, 16, 8)
        before = build.launch_counts()
        limb_matmul(_t(a), _t(b), 2)
        assert build.launch_counts() == before and build.BUILD_COUNT == 0


def _dd_checks(hi, lo, a, b):
    """(hi + lo) against an f64 product, over the result's scale, and |lo|
    against max|hi|: the reference's two bounds for its own kernel."""
    hi, lo = np.asarray(hi, np.float64), np.asarray(lo, np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    assert np.abs(hi + lo - ref).max() / scale < DD_F64_TOL
    assert np.abs(lo).max() < np.abs(hi).max() * DD_LO_RATIO
    return (hi + lo) / scale


class TestLimbMatmulDD:
    def test_vs_reference_kernel_at_its_test_shape(self, rng):
        a, b = _ab(rng, 64, 128, 64)
        hi, lo = limb_matmul_dd(_t(a), _t(b), 3, **BLK)
        j_hi, j_lo = j_limb_matmul_dd(jnp.asarray(a), jnp.asarray(b), 3,
                                      interpret=True, **BLK)
        got = _dd_checks(hi.numpy(), lo.numpy(), a, b)
        want = _dd_checks(np.asarray(j_hi), np.asarray(j_lo), a, b)
        assert np.abs(got - want).max() < DD_F64_TOL

    @pytest.mark.parametrize("k,m,kd,n", [(4, 64, 256, 64), (6, 32, 192, 48),
                                          (4, 17, 33, 9), (6, 17, 33, 9)])
    def test_against_f64(self, rng, k, m, kd, n):
        a, b = _ab(rng, m, kd, n)
        hi, lo = limb_matmul_dd(_t(a), _t(b), k, bm=32, bn=32, bk=64)
        _dd_checks(hi.numpy(), lo.numpy(), a, b)

    def test_fold_step_is_the_kernel_grain_and_both_grains_agree(self, rng):
        a, b = _ab(rng, 16, 256, 24)
        slab = limb_matmul_dd_plain(_t(a), _t(b), 4, bk=128)
        fine = limb_matmul_dd_plain(_t(a), _t(b), 4, bk=128, fold=k_step(4))
        assert (k_step(3), k_step(4), k_step(6)) == (64, 32, 32)
        assert torch.equal(limb_matmul_dd(_t(a), _t(b), 4, bk=128)[0], slab[0])
        got = _dd_checks(fine[0].numpy(), fine[1].numpy(), a, b)
        want = _dd_checks(slab[0].numpy(), slab[1].numpy(), a, b)
        assert np.abs(got - want).max() < DD_F64_TOL

    def test_more_accurate_than_the_f32_limb_kernel(self, rng):
        a, b = _ab(rng, 32, 1024, 32)
        ref = a.astype(np.float64) @ b.astype(np.float64)
        hi, lo = limb_matmul_dd(_t(a), _t(b), 3, bk=64)
        dd_err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - ref).max()
        f32_err = np.abs(limb_matmul(_t(a), _t(b), 3, bk=64).numpy() - ref).max()
        assert dd_err < f32_err

    def test_cuda_branch_checks_operands_before_building(self, rng):
        a, b = _ab(rng, 8, 16, 8)
        with pytest.raises(ValueError, match="CUDA tensors"):
            limb_ops._launch_dd(_t(a), _t(b), 4, 8, 8, 16, 1)
        with pytest.raises(ValueError, match="2-D operands"):
            limb_matmul_dd(_t(a)[None], _t(b))
        assert build.BUILD_COUNT == 0
        before = build.launch_counts()
        limb_matmul_dd(_t(a), _t(b), 4)
        assert build.launch_counts() == before and before["limb_matmul_dd"] == 0


class TestTileMatmul:
    @pytest.mark.parametrize("mode", F32_MODES)
    @pytest.mark.parametrize(
        "m,kd,n", [(64, 128, 64), (100, 300, 70), (1, 96, 48), (48, 96, 1), (16, 24, 16)])
    def test_uniform_map_bitwise_vs_limb_and_close_to_reference(self, rng, mode, m, kd, n):
        a, b = _ab(rng, m, kd, n)
        tile = tile_matmul_mode(_t(a), _t(b), mode, **BLK)
        limb = limb_matmul(_t(a), _t(b), MODE_LIMBS[mode], **BLK)
        assert torch.equal(tile, limb)
        want = np.asarray(j_tile.tile_matmul_mode(jnp.asarray(a), jnp.asarray(b),
                                                  int(mode), interpret=True, **BLK))
        _close(tile.numpy(), want)

    @pytest.mark.parametrize("mode", F32_MODES)
    def test_runtime_bitwise_vs_static(self, rng, mode):
        a, b = _ab(rng, 40, 200, 72)
        static = tile_matmul_mode(_t(a), _t(b), mode, **BLK)
        assert torch.equal(tile_matmul_runtime(_t(a), _t(b), int(mode), **BLK), static)
        dev_scalar = torch.tensor(int(mode), dtype=torch.int32)
        assert torch.equal(tile_matmul_runtime(_t(a), _t(b), dev_scalar, **BLK), static)

    @pytest.mark.parametrize("rounding", ["grte", "trunc"])
    def test_rounding_prepass_composition_bitwise(self, rng, rounding):
        a, b = _ab(rng, 32, 64, 32)
        for mode in F32_MODES:
            tile = tile_matmul_mode(_t(a), _t(b), mode, rounding=rounding, **BLK)
            limb = limb_matmul(_t(a), _t(b), MODE_LIMBS[mode], rounding=rounding, **BLK)
            assert torch.equal(tile, limb)

    @pytest.mark.parametrize("per_k", [False, True])
    def test_mixed_map_vs_reference_kernel_and_loop_oracle(self, rng, per_k):
        m, kd, n = 96, 192, 64
        a, b = _ab(rng, m, kd, n)
        grid, (bm, bn, bk) = tile_grid(m, n, kd, **BLK)
        mode_map = rng.integers(1, 4, size=grid if per_k else grid[:2]).astype(np.int32)
        got = tile_matmul(_t(a), _t(b), _t(mode_map), **BLK).numpy()
        want = np.asarray(j_tile.tile_matmul(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(mode_map), interpret=True, **BLK))
        _close(got, want)
        _close(got, tile_matmul_ref(a, b, mode_map, bm=bm, bn=bn, bk=bk).numpy())

    def test_ragged_mixed_map(self, rng):
        m, kd, n = 17, 33, 9
        a, b = _ab(rng, m, kd, n)
        grid, _ = tile_grid(m, n, kd, bm=8, bn=8, bk=16)
        mode_map = rng.integers(1, 4, size=grid).astype(np.int32)
        got = tile_matmul(_t(a), _t(b), _t(mode_map), bm=8, bn=8, bk=16).numpy()
        want = np.asarray(j_tile.tile_matmul(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(mode_map), interpret=True,
                                             bm=8, bn=8, bk=16))
        _close(got, want)

    def test_map_shape_validated(self, rng):
        a, b = _ab(rng, 64, 64, 64)
        with pytest.raises(ValueError, match="mode_map shape"):
            tile_matmul(_t(a), _t(b), torch.ones((3, 3), dtype=torch.int32), **BLK)
        with pytest.raises(ValueError, match="f32 ladder"):
            tile_matmul_mode(_t(a), _t(b), Mode.M32)

    @pytest.mark.parametrize("per_k", [False, True])
    def test_magnitude_map_equal_as_integers(self, rng, per_k):
        a, b = _ab(rng, 128, 256, 128)
        a[:32, :64] *= 1e3  # one outlier tile
        b[:, 96:] *= 1e-3
        for budget in (2.0**-10, 2.0**-14, 2.0**-18):
            want = np.asarray(j_magnitude_map(jnp.asarray(a), jnp.asarray(b), budget,
                                              per_k=per_k, **BLK))
            got = magnitude_map(_t(a), _t(b), budget, per_k=per_k, **BLK)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want)
        assert len(np.unique(got.numpy())) >= 2

    def test_magnitude_auto_meets_budget_and_matches_reference(self, rng):
        a, b = _ab(rng, 64, 128, 64)
        a[:32] *= 50.0
        budget = 2.0**-12
        got = tile_matmul_auto(_t(a), _t(b), budget, **BLK).numpy()
        want = np.asarray(j_tile.tile_matmul_auto(jnp.asarray(a), jnp.asarray(b), budget,
                                                  interpret=True, **BLK))
        _close(got, want)
        ref = a.astype(np.float64) @ b.astype(np.float64)
        envelope = np.abs(a).max() * np.abs(b).max() * 128
        assert np.abs(got - ref).max() <= budget * envelope

    def test_map_builders(self):
        u = uniform_map((4, 6, 96), (96, 40), Mode.M16, **BLK)
        assert tuple(u.shape) == (1, 2) and int(u.unique()) == 2
        t = table_map((64, 96), (96, 40), 7, per_k=True, **BLK)
        assert tuple(t.shape) == (2, 2, 2) and int(t.unique()) == 3
        d = table_map((64, 96), (96, 40), torch.tensor(0), **BLK)
        assert int(d.unique()) == 1
        with pytest.raises(ValueError):
            uniform_map((64, 96), (96, 40), Mode.M48)
