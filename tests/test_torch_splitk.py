"""The split-K layout of the limb and mode-map kernels, on the CPU.

``split_k`` and the walk helpers are plain integer arithmetic shared with
``csrc/rmpm_gemm.cuh``; the plain versions take ``splits=`` and sum the same
per-split partials in the same order as the kernels, so the CUDA kernels
(held against them on the card by ``chip_smoke.py``) and these tests hold
one layout.  Tolerances: against the reference's kernels (interpret mode)
2e-6 of the result scale, the bound the reference holds its own kernels to
(splitting K reorders the f32 accumulation); every in-port identity bitwise.
"""
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypothesis_compat import given, settings, st

from repro.kernels.limb_matmul.ops import limb_matmul as j_limb_matmul
from repro.kernels.tile_matmul import ops as j_tile

from repro_torch.core.limb import limb_product_terms
from repro_torch.core.precision import F32_MODES, MODE_LIMBS
from repro_torch.kernels import build
from repro_torch.kernels.limb_matmul import ops as limb_ops
from repro_torch.kernels.limb_matmul.ops import (
    BLOCKS_PER_SM,
    MAX_SPLIT_LEN,
    gemm_blocks,
    k_step,
    k_steps,
    k_walk,
    limb_matmul,
    limb_matmul_plain,
    reduce_splits,
    resolve_splits,
    split_k,
    split_pieces,
    split_ranges,
    tile_grid,
)
from repro_torch.kernels.tile_matmul import ops as tile_ops
from repro_torch.kernels.tile_matmul.ops import (
    tile_matmul,
    tile_matmul_mode,
    tile_matmul_plain,
    tile_matmul_runtime,
)

TOL = 2e-6
H100_SMS = 132
#: (M, K, N) of the serving path's weight GEMMs (decode M = 4, prefill M = 48)
SERVING = [(m, k, n) for m in (4, 48) for (k, n) in ((1024, 1024), (1024, 2816), (2816, 1024))]


def _ab(seed, m, kd, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, kd)).astype(np.float32),
            rng.standard_normal((kd, n)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


def _plan(m, kd, n, k=3, sms=H100_SMS, **blk):
    _, (bm, bn, bk) = tile_grid(m, n, kd, **blk)
    return split_k(m, n, kd, bm=bm, bn=bn, bk=bk, tk=k_step(k), sms=sms)


# ---------------------------------------------------------------------------
# the walk and split_k
# ---------------------------------------------------------------------------


problems = st.tuples(
    st.integers(1, 300),                      # m
    st.integers(1, 300),                      # n
    st.integers(1, 3000),                     # kdim
    st.sampled_from([8, 16, 32, 48, 128]),    # bm
    st.sampled_from([8, 16, 40, 128]),        # bn
    st.sampled_from([8, 16, 24, 40, 64, 100, 128, 200, 512]),  # bk: < TK, ragged, multiples
    st.sampled_from([32, 64]),                # tk
    st.integers(1, 200),                      # sms
)


@settings(max_examples=300, deadline=None)
@given(problems)
def test_splits_cover_every_step_of_the_walk_once_and_in_order(p):
    m, n, kd, bm, bn, bk, tk, sms = p
    _, (bm, bn, bk) = tile_grid(m, n, kd, bm=bm, bn=bn, bk=bk)
    walk = k_walk(kd, bk, tk)
    assert k_steps(kd, bk, tk) == len(walk)
    # the walk itself: slab by slab, TK steps inside a slab, covering [0, K)
    assert walk[0][1] == 0 and walk[-1][2] == kd
    for (kk, k0, k1), nxt in zip(walk, walk[1:] + [None]):
        assert kk * bk <= k0 < k1 <= min((kk + 1) * bk, kd) and k1 - k0 <= tk
        if nxt is not None:
            assert nxt[1] == k1 and nxt[0] in (kk, kk + 1)
    s = split_k(m, n, kd, bm=bm, bn=bn, bk=bk, tk=tk, sms=sms)
    assert 1 <= s <= len(walk)
    ranges = split_ranges(len(walk), s)
    assert all(t1 > t0 for t0, t1 in ranges)  # no split gets less than one step
    assert [step for t0, t1 in ranges for step in walk[t0:t1]] == walk
    # the plain versions' pieces: the same steps, merged inside a slab only
    pieces = split_pieces(kd, bk, tk, s)
    flat = [pc for split in pieces for pc in split]
    assert flat[0][1] == 0 and flat[-1][2] == kd
    assert all(a[2] == b[1] for a, b in zip(flat, flat[1:]))
    assert all(kk * bk <= k0 < k1 <= min((kk + 1) * bk, kd) for kk, k0, k1 in flat)


@settings(max_examples=300, deadline=None)
@given(problems)
def test_split_k_fills_the_card_and_stops_when_the_grid_does(p):
    m, n, kd, bm, bn, bk, tk, sms = p
    _, (bm, bn, bk) = tile_grid(m, n, kd, bm=bm, bn=bn, bk=bk)
    s = split_k(m, n, kd, bm=bm, bn=bn, bk=bk, tk=tk, sms=sms)
    blocks = gemm_blocks(m, n, bm, bn)
    assert 1 <= s <= k_steps(kd, bk, tk)
    if blocks > sms:
        assert s == 1
    else:
        assert s == min(BLOCKS_PER_SM * sms // blocks, k_steps(kd, bk, tk))
    assert blocks * s <= max(BLOCKS_PER_SM * sms, blocks)


@pytest.mark.parametrize("m,kd,n", [(4, 33792, 12288), (48, 33792, 12288), (4, 16385, 9000),
                                    (4, 16384, 9000), (4, 12288, 4096)])
def test_no_split_sums_more_than_max_split_len(m, kd, n):
    """A full grid is split all the same once K passes ``MAX_SPLIT_LEN``
    (command-r+'s down projection, K = 33792, in three splits), and every
    split's stretch of K stays within it; K <= MAX_SPLIT_LEN keeps the
    grid-only split."""
    _, (bm, bn, bk) = tile_grid(m, n, kd)
    tk = k_step(3)
    s = _plan(m, kd, n)
    walk = k_walk(kd, bk, tk)
    for t0, t1 in split_ranges(len(walk), s):
        assert walk[t1 - 1][2] - walk[t0][1] <= MAX_SPLIT_LEN
    fill = BLOCKS_PER_SM * H100_SMS // gemm_blocks(m, n, bm, bn)
    if kd <= MAX_SPLIT_LEN:
        assert s == max(1, min(fill, len(walk)))
    else:
        assert s == max(fill, -(-kd // MAX_SPLIT_LEN)) > 1
    if (m, kd, n) == (4, 33792, 12288):
        assert s == 3


@pytest.mark.parametrize("m,kd,n", SERVING + [(1, 96, 48), (17, 33, 9), (100, 3000, 70)])
def test_split_k_is_the_same_at_every_f32_ladder_limb_count(m, kd, n):
    assert len({_plan(m, kd, n, k) for k in (1, 2, 3)}) == 1
    assert {k_step(k) for k in (1, 2, 3)} == {64}


@pytest.mark.parametrize("m,kd,n,want", [
    (4, 1024, 1024, 8), (4, 2816, 1024, 8), (4, 1024, 2816, 3),
    (48, 1024, 1024, 4), (48, 2816, 1024, 4), (48, 1024, 2816, 1),
    (1024, 1024, 1024, 1), (4096, 4096, 4096, 1)])
def test_planned_splits_at_the_serving_and_tuner_shapes_on_132_sms(m, kd, n, want):
    assert _plan(m, kd, n) == want


def test_resolve_splits(monkeypatch):
    args = dict(bm=8, bn=128, bk=512, tk=64)
    assert resolve_splits(None, torch.device("cpu"), 4, 1024, 2816, **args) == 1
    assert resolve_splits(5, torch.device("cpu"), 4, 1024, 2816, **args) == 5
    monkeypatch.setattr(limb_ops, "_sm_count", lambda index: H100_SMS)
    # (m, n, kdim) = (4, 1024, 2816): 32 blocks, 44 steps
    assert resolve_splits(None, torch.device("cuda", 0), 4, 1024, 2816, **args) == 8
    assert resolve_splits(2, torch.device("cuda", 0), 4, 1024, 2816, **args) == 2
    for bad in (0, 45):
        with pytest.raises(ValueError, match="splits must lie in"):
            resolve_splits(bad, torch.device("cuda", 0), 4, 1024, 2816, **args)


# ---------------------------------------------------------------------------
# the plain versions at a split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kd", [320, 300])  # 5 slabs of 64; the last one ragged
@pytest.mark.parametrize("splits", [2, 3, 5])
def test_plain_versions_add_per_split_partials_in_split_order(kd, splits):
    """With bk = TK every step is a slab, so split s is the unsplit plain
    version on its own columns (and, for the map, its own slabs)."""
    m, n, bk = 20, 24, 64
    a, b = (_t(x) for x in _ab(1, m, kd, n))
    grid, (bm, bn, _) = tile_grid(m, n, kd, bm=16, bn=16, bk=bk)
    mode_map = torch.from_numpy(np.random.default_rng(2).integers(1, 4, grid).astype(np.int32))
    walk = k_walk(kd, bk, k_step(3))
    limb_parts, tile_parts = [], []
    for t0, t1 in split_ranges(len(walk), splits):
        lo, hi = walk[t0][1], walk[t1 - 1][2]
        limb_parts.append(limb_matmul_plain(a[:, lo:hi], b[lo:hi], 3, bk=bk))
        tile_parts.append(tile_matmul_plain(a[:, lo:hi], b[lo:hi], mode_map[:, :, t0:t1],
                                            kmax=3, bm=bm, bn=bn, bk=bk))
    assert torch.equal(limb_matmul_plain(a, b, 3, bk=bk, splits=splits), reduce_splits(limb_parts))
    assert torch.equal(tile_matmul_plain(a, b, mode_map, kmax=3, bm=bm, bn=bn, bk=bk,
                                         splits=splits), reduce_splits(tile_parts))
    assert torch.equal(reduce_splits(limb_parts),
                       functools.reduce(lambda x, y: x + y, limb_parts))


def test_one_split_is_the_unsplit_walk():
    a, b = (_t(x) for x in _ab(3, 12, 300, 20))
    al, bl = limb_ops.extract_limbs(a, 3), limb_ops.extract_limbs(b, 3)
    acc = torch.zeros((12, 20))
    for k0 in range(0, 300, 128):  # the slab walk the plain version had before splits
        for i, j in limb_product_terms(3):
            acc = acc + al[i][:, k0:k0 + 128] @ bl[j][k0:k0 + 128]
    assert torch.equal(limb_matmul_plain(a, b, 3, bk=128), acc)
    assert torch.equal(limb_matmul(a, b, 3, bk=128), acc)  # CPU default: one split
    assert torch.equal(limb_matmul(a, b, 3, bk=128, splits=1), acc)


@pytest.mark.parametrize("mode", F32_MODES)
@pytest.mark.parametrize("m,kd,n,blk", [
    (40, 300, 72, dict(bm=32, bn=32, bk=64)),    # ragged last slab
    (17, 100, 9, dict(bm=16, bn=16, bk=16)),     # bk < TK
    (24, 300, 40, dict(bm=16, bn=16, bk=80)),    # bk not a multiple of TK
])
def test_uniform_map_bitwise_equals_limb_plain_at_every_split(mode, m, kd, n, blk):
    a, b = (_t(x) for x in _ab(4, m, kd, n))
    k = MODE_LIMBS[mode]
    _, (_, _, bk) = tile_grid(m, n, kd, **blk)
    for splits in range(1, k_steps(kd, bk, k_step(k)) + 1):
        limb = limb_matmul(a, b, k, splits=splits, **blk)
        assert torch.equal(tile_matmul_mode(a, b, mode, splits=splits, **blk), limb)
        assert torch.equal(tile_matmul_runtime(a, b, k, splits=splits, **blk), limb)
        dev_scalar = torch.tensor(k, dtype=torch.int32)
        assert torch.equal(tile_matmul_runtime(a, b, dev_scalar, splits=splits, **blk), limb)


# ---------------------------------------------------------------------------
# against the reference's kernels (interpret mode)
# ---------------------------------------------------------------------------

CASES = {
    "ragged": (100, 300, 70, dict(bm=32, bn=32, bk=64)),
    "bk_below_tk": (17, 100, 9, dict(bm=16, bn=16, bk=16)),
    "bk_not_multiple": (24, 300, 40, dict(bm=16, bn=16, bk=80)),
}


@functools.lru_cache(maxsize=None)
def _reference_limb(case, k):
    m, kd, n, blk = CASES[case]
    a, b = _ab(5, m, kd, n)
    return np.asarray(j_limb_matmul(jnp.asarray(a), jnp.asarray(b), k, interpret=True, **blk))


@functools.lru_cache(maxsize=None)
def _reference_tile(case, per_k):
    m, kd, n, blk = CASES[case]
    a, b = _ab(5, m, kd, n)
    grid, _ = tile_grid(m, n, kd, **blk)
    mode_map = np.random.default_rng(6).integers(1, 4, grid if per_k else grid[:2]).astype(np.int32)
    want = np.asarray(j_tile.tile_matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mode_map),
                                         interpret=True, **blk))
    return mode_map, want


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_limb_plain_at_a_split_vs_reference_kernel(k, case, splits):
    m, kd, n, blk = CASES[case]
    a, b = _ab(5, m, kd, n)
    _close(limb_matmul(_t(a), _t(b), k, splits=splits, **blk).numpy(), _reference_limb(case, k))


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("per_k", [False, True])
def test_tile_plain_at_a_split_vs_reference_kernel(per_k, case, splits):
    m, kd, n, blk = CASES[case]
    a, b = _ab(5, m, kd, n)
    mode_map, want = _reference_tile(case, per_k)
    _close(tile_matmul(_t(a), _t(b), _t(mode_map), splits=splits, **blk).numpy(), want)


def test_mode_error_ladder_strictly_falls_at_three_splits():
    a, b = _ab(7, 64, 384, 64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    errs = [np.abs(limb_matmul(_t(a), _t(b), k, bm=32, bn=32, bk=64, splits=3).numpy()
                   .astype(np.float64) - ref).max() / np.abs(ref).max() for k in (1, 2, 3)]
    assert errs[0] > errs[1] > errs[2]


# ---------------------------------------------------------------------------
# the wrappers' split argument
# ---------------------------------------------------------------------------


def test_out_of_range_splits_raise_before_anything_runs():
    a, b = (_t(x) for x in _ab(8, 4, 200, 16))  # bk clamps to 200: 4 steps of 64
    before = build.launch_counts()
    for bad in (0, 5):
        with pytest.raises(ValueError, match="splits must lie in"):
            limb_matmul(a, b, 2, splits=bad)
        with pytest.raises(ValueError, match="splits must lie in"):
            tile_matmul_runtime(a, b, 2, splits=bad)
    with pytest.raises(ValueError, match="splits must lie in"):
        limb_matmul_plain(a, b, 2, splits=5)
    assert build.launch_counts() == before and build.BUILD_COUNT == 0


def test_cuda_launch_paths_check_operands_before_building():
    a, b = (_t(x) for x in _ab(9, 8, 128, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        limb_ops._launch(a, b, 3, 8, 8, 64, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tile_ops._launch(a, b, torch.ones((1, 1), dtype=torch.int32), 3, 8, 8, 64, 2)
    assert build.BUILD_COUNT == 0
