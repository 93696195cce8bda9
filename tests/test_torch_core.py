"""Port vs reference, bit-level pieces: the same numpy inputs go through the
JAX function and its PyTorch counterpart and must agree BIT FOR BIT."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import limb as jlimb
from repro.core import precision as jprec
from repro.core.rounding import quantize_mantissa as jquant
from repro.kernels import blocking as jblk
from repro.kernels.tile_matmul.ops import tile_grid as jtile_grid

from repro_torch.core import limb as tlimb
from repro_torch.core import precision as tprec
from repro_torch.core.rounding import quantize_mantissa as tquant
from repro_torch.kernels import blocking as tblk
from repro_torch.kernels.tile_matmul.ops import tile_grid as ttile_grid

SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-41, -3e-39, 1.0, -1.5,
     np.finfo(np.float32).max, np.finfo(np.float32).tiny, 65504.0],
    np.float32)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _data(rng, shape=(57, 131)):
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, shape)).astype(np.float32)
    x.reshape(-1)[: SPECIALS.size] = SPECIALS
    return x


def test_mode_tables_equal():
    assert {int(m): k for m, k in jprec.MODE_LIMBS.items()} == {
        int(m): k for m, k in tprec.MODE_LIMBS.items()}
    assert {int(m): k for m, k in jprec.MODE_PASSES.items()} == {
        int(m): k for m, k in tprec.MODE_PASSES.items()}
    assert [int(m) for m in jprec.F32_MODES] == [int(m) for m in tprec.F32_MODES]
    assert [int(m) for m in jprec.DF32_MODES] == [int(m) for m in tprec.DF32_MODES]


def test_classify_bit_equal(rng):
    x = _data(rng)
    want = jprec.classify(jnp.asarray(x))
    got = tprec.classify(torch.from_numpy(x))
    assert set(want) == set(got)
    for key in want:
        assert np.array_equal(np.asarray(want[key]), got[key].numpy()), key
    assert got["denormal"].any() and got["nan"].any() and got["infinity"].any()


@pytest.mark.parametrize("rounding", ["trunc", "rne", "grte"])
@pytest.mark.parametrize("keep", [1, 5, 7, 15, 20, 22])
def test_quantize_mantissa_bit_equal(rng, rounding, keep):
    x = _data(rng)
    want = np.asarray(jquant(jnp.asarray(x), keep, rounding))
    got = tquant(torch.from_numpy(x), keep, rounding).numpy()
    assert np.array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("keep", [0, -1])
def test_quantize_mantissa_rejects_nonpositive_keep(keep):
    with pytest.raises(ValueError, match="keep_bits must be >= 1"):
        tquant(torch.zeros(4), keep, "grte")
    with pytest.raises(ValueError, match="rounding must be one of"):
        tquant(torch.zeros(4), 7, "nearest")


def test_quantize_mantissa_f64_matches_numpy_semantics(rng):
    x = rng.standard_normal(64)
    got = tquant(torch.from_numpy(x), 52, "grte").numpy()
    assert np.array_equal(got, x)  # keep == mantissa width: identity
    low = tquant(torch.from_numpy(x), 23, "rne").numpy()
    assert np.array_equal(low, x.astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("rounding", ["rne", "grte", "trunc"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_split_limbs_bit_equal(rng, k, rounding):
    x = _data(rng, (33, 65))
    # finite, normal inputs: XLA's CPU backend flushes the denormal residual
    # of a denormal input to +0 where PyTorch keeps it (a signed-zero
    # difference in the second limb) — logged in ROADMAP Queue C
    normal = np.isfinite(x) & ((np.abs(x) >= np.finfo(np.float32).tiny) | (x == 0))
    # and below bf16's largest finite value: above it the first limb is inf
    # and the last a NaN, whose payload bits are the backend's own
    normal &= np.abs(x) < 3.0e38
    x = np.where(normal, x, 1.0).astype(np.float32)
    want = np.asarray(jlimb.split_limbs(jnp.asarray(x), k, rounding).astype(jnp.float32))
    got = tlimb.split_limbs(torch.from_numpy(x), k, rounding).to(torch.float32).numpy()
    assert want.shape == got.shape == (k, 33, 65)
    assert np.array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("k", [4, 6])
def test_split_limbs_doublef32_lo_injection_bit_equal(rng, k):
    x64 = rng.standard_normal((16, 24)) * 3.0
    jd = jprec.DoubleF32(jnp.asarray(x64.astype(np.float32)),
                         jnp.asarray((x64 - x64.astype(np.float32)).astype(np.float32)))
    td = tprec.df32_from_f64(torch.from_numpy(x64))
    assert np.array_equal(_bits(jd.hi), _bits(td.hi.numpy()))
    assert np.array_equal(_bits(jd.lo), _bits(td.lo.numpy()))
    want = np.asarray(jlimb.split_limbs(jd, k).astype(jnp.float32))
    got = tlimb.split_limbs(td, k).to(torch.float32).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    assert np.abs(got[3]).max() > 0  # the lo word really entered at limb 3
    rec = tlimb.reconstruct(tlimb.split_limbs(td, k)).numpy()
    assert np.array_equal(_bits(rec), _bits(np.asarray(jlimb.reconstruct(jlimb.split_limbs(jd, k)))))


@pytest.mark.parametrize("rounding", ["rne", "grte"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_split_limbs_f32_equals_the_reference_limbs_and_keeps_its_operand(rng, k, rounding):
    """The f32 limbs the limb algebra multiplies (made one at a time, the
    residual updated in place) are the reference's bf16 limbs upcast, bit
    for bit, and the operand is left as it was."""
    x = rng.standard_normal((17, 40)).astype(np.float32)
    want = np.asarray(jlimb.split_limbs(jnp.asarray(x), k, rounding).astype(jnp.float32))
    t = torch.from_numpy(x.copy())
    got = tlimb.split_limbs_f32(t, k, rounding)
    assert len(got) == k and all(li.dtype == torch.float32 for li in got)
    assert np.array_equal(_bits(want), _bits(torch.stack(got).numpy()))
    assert np.array_equal(t.numpy(), x)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6])
def test_limb_product_terms_equal(k):
    assert jlimb.limb_product_terms(k) == tlimb.limb_product_terms(k)
    assert len(tlimb.limb_product_terms(k)) == k * (k + 1) // 2


@pytest.mark.parametrize("block,dim", [(128, 1), (128, 4), (128, 17), (128, 128),
                                       (128, 300), (512, 9), (512, 2816), (32, 0)])
def test_clamp_block_equal(block, dim):
    assert jblk.clamp_block(block, dim) == tblk.clamp_block(block, dim)
    assert jblk.ceil_to(dim, 8) == tblk.ceil_to(dim, 8)


@pytest.mark.parametrize("m,n,k", [(4, 1024, 1024), (48, 2816, 1024), (17, 9, 33),
                                   (1, 48, 96), (130, 300, 1100), (100, 70, 300)])
@pytest.mark.parametrize("blk", [dict(), dict(bm=32, bn=32, bk=64)])
def test_tile_grid_equal(m, n, k, blk):
    assert jtile_grid(m, n, k, **blk) == ttile_grid(m, n, k, **blk)


def test_pad_to_block_equal(rng):
    x = rng.standard_normal((17, 33)).astype(np.float32)
    want = np.asarray(jblk.pad_to_block(jnp.asarray(x), 8, 16))
    got = tblk.pad_to_block(torch.from_numpy(x), 8, 16).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("case", ["integers", "bf16_exact", "two_limb", "full_f32"])
@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_auto_mode_equal(rng, case, tol):
    a = rng.standard_normal((16, 32)).astype(np.float32)
    b = rng.standard_normal((32, 8)).astype(np.float32)
    if case == "integers":
        a, b = np.round(a * 4), np.round(b * 4)
    elif case == "bf16_exact":
        a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        b = np.asarray(jnp.asarray(b).astype(jnp.bfloat16).astype(jnp.float32))
    elif case == "two_limb":
        def two(x):
            hi = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
            lo = (jnp.asarray(x) - hi).astype(jnp.bfloat16).astype(jnp.float32)
            return np.asarray(hi + lo)
        a, b = two(a), two(b)
    want = int(jprec.auto_mode(jnp.asarray(a), jnp.asarray(b), tol=tol))
    got = tprec.auto_mode(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)), tol=tol)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want


def test_mode_mismatch_error():
    assert bool(tprec.mode_mismatch_error(1, 2)) and not bool(tprec.mode_mismatch_error(3, 3))
