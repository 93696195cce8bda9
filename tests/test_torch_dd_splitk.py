"""The split-K layout of the double-f32 kernel, on the CPU.

The CUDA kernel ``csrc/limb_matmul_dd.cu`` runs S splits of the thread
block's K walk, each renormalizing its own (sum, compensation) pair, and
``splitk_reduce_dd`` folds the pairs in the order s = 0..S-1: TwoSum on hi,
a plain add on lo, a renormalization at the end.  ``limb_matmul_dd_plain``
mirrors that with ``splits=``, and the wrapper runs it for CPU tensors; the
kernel is held against it on the card by ``chip_smoke.py``.

Tolerances: against the reference's Pallas kernel in interpret mode and
against ``repro.core.rmpm._limb_matmul_dd`` (the validation-grade TwoSum
scan over K), 2^-22 of the result's scale — the bound the reference holds
its own kernel to, and what two double-f32 sums that fold plain-f32 partial
products in different orders may differ by; |lo| < 2^-20 max|hi|, the
reference's bound on the pair's normalization.  Every in-port identity (one
split against the unsplit walk, the reduction's order) is bitwise.
"""
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.rmpm import _limb_matmul_dd as j_scan_dd
from repro.kernels.limb_matmul.limb_matmul import limb_matmul_dd_pallas as j_limb_matmul_dd

from repro_torch.core.limb import limb_product_terms
from repro_torch.kernels import build
from repro_torch.kernels.limb_matmul import ops as limb_ops
from repro_torch.kernels.limb_matmul.ops import (
    k_step,
    k_steps,
    k_walk,
    limb_matmul_dd,
    limb_matmul_dd_plain,
    reduce_splits_dd,
    resolve_splits,
    split_k,
    split_pieces,
    split_ranges,
    tile_grid,
)

DD_F64_TOL = 2.0**-22
DD_LO_RATIO = 2.0**-20
H100_SMS = 132
#: (M, K, N, blocks): the reference's test shape, a ragged shape with bk
#: below the K step (every step a slab of 11), and a narrow serving-like
#: shape (M = 4 rows, four slabs of 176); blocks that divide the shapes, as
#: the Pallas kernel needs
SHAPES = {
    "64x128x64": (64, 128, 64, dict(bm=32, bn=32, bk=64)),
    "17x33x9": (17, 33, 9, dict(bm=17, bn=9, bk=11)),
    "4x704x96": (4, 704, 96, dict(bm=4, bn=96, bk=176)),
}


def _ab(seed, m, kd, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, kd)).astype(np.float32),
            rng.standard_normal((kd, n)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _walk_len(name, k):
    m, kd, n, blk = SHAPES[name]
    _, (_, _, bk) = tile_grid(m, n, kd, **blk)
    return k_steps(kd, bk, k_step(k))


def _split_counts(name, k):
    steps = _walk_len(name, k)
    return sorted({s for s in (1, 2, 3, steps) if s <= steps})


@functools.lru_cache(maxsize=None)
def _references(name, k):
    """(hi + lo) of the reference's Pallas kernel (interpret mode) and of its
    TwoSum scan over K, in f64."""
    m, kd, n, blk = SHAPES[name]
    a, b = _ab(11, m, kd, n)
    hi, lo = j_limb_matmul_dd(jnp.asarray(a), jnp.asarray(b), k, interpret=True, **blk)
    scan = j_scan_dd(jnp.asarray(a), jnp.asarray(b), k)
    return ((np.asarray(hi, np.float64) + np.asarray(lo, np.float64)),
            (np.asarray(scan.hi, np.float64) + np.asarray(scan.lo, np.float64)))


# ---------------------------------------------------------------------------
# the plain version at a split, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split_idx", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("k", [3, 4, 6])
def test_split_plain_vs_reference_kernel_and_scan(k, name, split_idx):
    counts = _split_counts(name, k)
    splits = counts[min(split_idx, len(counts) - 1)]
    m, kd, n, blk = SHAPES[name]
    a, b = _ab(11, m, kd, n)
    hi, lo = limb_matmul_dd(_t(a), _t(b), k, splits=splits, **blk)
    hi, lo = hi.numpy().astype(np.float64), lo.numpy().astype(np.float64)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    kernel, scan = _references(name, k)
    assert np.abs(hi + lo - kernel).max() / scale < DD_F64_TOL
    assert np.abs(hi + lo - scan).max() / scale < DD_F64_TOL
    assert np.abs(hi + lo - exact).max() / scale < DD_F64_TOL
    assert np.abs(lo).max() < DD_LO_RATIO * np.abs(hi).max()


@pytest.mark.parametrize("k", [3, 4, 6])
def test_split_counts_cover_one_to_the_walk(k):
    """The parametrization above reaches S = 1, 2, 3 and the walk's full
    length wherever the walk is that long."""
    for name in SHAPES:
        counts = _split_counts(name, k)
        assert counts[0] == 1 and counts[-1] == _walk_len(name, k)
    assert _split_counts("4x704x96", k) == [1, 2, 3, _walk_len("4x704x96", k)]


# ---------------------------------------------------------------------------
# in-port identities
# ---------------------------------------------------------------------------


def _unsplit_walk(a, b, k, bk, fold):
    """The plain version as it was before splits: slab by slab, steps of
    ``fold`` inside a slab (one fold per slab when None), one pair."""
    al, bl = limb_ops.extract_limbs(a, k), limb_ops.extract_limbs(b, k)
    s = torch.zeros((a.shape[0], b.shape[1]))
    c = torch.zeros_like(s)
    for k0 in range(0, a.shape[1], bk):
        k_end = min(k0 + bk, a.shape[1])
        step = k_end - k0 if fold is None else fold
        for f0 in range(k0, k_end, step):
            f1 = min(f0 + step, k_end)
            for i, j in limb_product_terms(k):
                s, e = limb_ops._two_sum(s, al[i][:, f0:f1] @ bl[j][f0:f1])
                c = c + e
    return limb_ops._two_sum(s, c)


@pytest.mark.parametrize("fold", [None, 32, 64])
@pytest.mark.parametrize("k", [3, 4, 6])
def test_one_split_is_the_unsplit_walk_bit_for_bit(k, fold):
    a, b = (_t(x) for x in _ab(12, 12, 300, 20))
    want = _unsplit_walk(a, b, k, 128, fold)
    got = limb_matmul_dd_plain(a, b, k, bk=128, fold=fold, splits=1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if fold is None:  # the CPU wrapper: one split, one fold per slab
        wrapped = limb_matmul_dd(a, b, k, bk=128)
        assert torch.equal(wrapped[0], want[0]) and torch.equal(wrapped[1], want[1])


def _fold_pairs_np(pairs):
    """The kernel's reduction written out in numpy f32, independently of
    ``reduce_splits_dd``: (s, c) = (hi_0, lo_0); for s = 1..S-1 TwoSum of
    hi_s into s, its error and then lo_s added to c; renormalized."""
    f = np.float32

    def two_sum(x, y):
        t = (x + y).astype(f)
        bb = (t - x).astype(f)
        return t, ((x - (t - bb)).astype(f) + (y - bb).astype(f)).astype(f)

    s, c = (np.asarray(x, f) for x in pairs[0])
    if len(pairs) == 1:
        return s, c
    for hi, lo in pairs[1:]:
        s, e = two_sum(s, np.asarray(hi, f))
        c = ((c + e).astype(f) + np.asarray(lo, f)).astype(f)
    return two_sum(s, c)


@pytest.mark.parametrize("k", [3, 4, 6])
@pytest.mark.parametrize("kd", [320, 300])  # five slabs of 64; the last one ragged
@pytest.mark.parametrize("splits", [2, 3, 5])
def test_split_pairs_are_folded_in_split_order(splits, kd, k):
    """Split s is the plain version on its own columns [walk[t0].k0,
    walk[t1-1].k_end), with the floor ranges s*T//S, folding once per K step
    (bk = fold = TK on the slice gives the walk's own steps, since every
    split starts on a step boundary); the pairs are then folded exactly as
    ``_fold_pairs_np`` spells out."""
    m, n, bk = 20, 24, 64
    a, b = (_t(x) for x in _ab(13, m, kd, n))
    walk = k_walk(kd, bk, k_step(k))
    steps = len(walk)
    assert split_ranges(steps, splits) == [
        (s * steps // splits, (s + 1) * steps // splits) for s in range(splits)]
    pairs = []
    for s in range(splits):
        t0, t1 = s * steps // splits, (s + 1) * steps // splits
        lo_k, hi_k = walk[t0][1], walk[t1 - 1][2]
        pairs.append(limb_matmul_dd_plain(a[:, lo_k:hi_k], b[lo_k:hi_k], k, bk=k_step(k),
                                          fold=k_step(k)))
    got = limb_matmul_dd_plain(a, b, k, bk=bk, fold=k_step(k), splits=splits)
    want = _fold_pairs_np([(h.numpy(), l.numpy()) for h, l in pairs])
    assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
    ported = reduce_splits_dd(pairs)
    assert torch.equal(ported[0], got[0]) and torch.equal(ported[1], got[1])


@pytest.mark.parametrize("k", [3, 4, 6])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_split_pairs_are_the_unsplit_walk_on_masked_columns(name, k):
    """What the exact split check of ``chip_smoke.py`` rests on: split s's
    pair is the unsplit walk over ``a`` with every K column outside the
    split's range zeroed (the zero steps leave the pair as it is), so the
    split result is those pairs folded by ``reduce_splits_dd``, bit for
    bit, at every split count of the parametrization above."""
    m, kd, n, blk = SHAPES[name]
    a, b = (_t(x) for x in _ab(18, m, kd, n))
    _, (_, _, bk) = tile_grid(m, n, kd, **blk)
    step = k_step(k)
    for splits in _split_counts(name, k)[1:]:
        pairs = []
        for pieces in split_pieces(kd, bk, step, splits):
            masked = torch.zeros_like(a)
            k0, k1 = pieces[0][1], pieces[-1][2]
            masked[:, k0:k1] = a[:, k0:k1]
            pairs.append(limb_matmul_dd_plain(masked, b, k, bk=bk, fold=step))
        got = limb_matmul_dd_plain(a, b, k, bk=bk, fold=step, splits=splits)
        want = reduce_splits_dd(pairs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _fold_pairs_plain_add_np(pairs):
    """The reduction with a plain f32 add in place of TwoSum on hi_s."""
    f = np.float32
    s, c = (np.asarray(x, f) for x in pairs[0])
    for hi, lo in pairs[1:]:
        s = (s + np.asarray(hi, f)).astype(f)
        c = (c + np.asarray(lo, f)).astype(f)
    t = (s + c).astype(f)
    bb = (t - s).astype(f)
    return t, ((s - (t - bb)).astype(f) + (c - bb).astype(f)).astype(f)


def test_reduction_order_matters_on_these_inputs():
    """The pair fold's bits depend on every part of its rule: folded in
    reverse, with lo_s dropped, or with a plain add on hi_s, the same pairs
    give other bits (what lets the order test above fail)."""
    rng = np.random.default_rng(14)
    pairs = []
    for _ in range(4):
        hi = (rng.standard_normal((64, 64)) * 1e3).astype(np.float32)
        lo = (rng.standard_normal((64, 64)) * 1e-4).astype(np.float32)
        pairs.append((hi, lo))
    want = _fold_pairs_np(pairs)
    t_pairs = [(_t(h), _t(l)) for h, l in pairs]
    got = reduce_splits_dd(t_pairs)
    assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
    for other in (_fold_pairs_np(pairs[::-1]),
                  _fold_pairs_np([pairs[0]] + [(h, np.zeros_like(l)) for h, l in pairs[1:]]),
                  _fold_pairs_plain_add_np(pairs)):
        assert not (np.array_equal(other[0], want[0]) and np.array_equal(other[1], want[1]))


# ---------------------------------------------------------------------------
# the split count and the wrapper's argument
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,kd,n,k,want", [
    (4, 2816, 1024, 4, 8), (4, 1024, 1024, 4, 8), (4, 1024, 2816, 4, 3),
    (48, 1024, 1024, 4, 4), (48, 2816, 1024, 4, 4), (48, 1024, 2816, 4, 1),
    (4, 2816, 1024, 6, 8), (4, 1024, 2816, 6, 3), (48, 1024, 2816, 6, 1)])
def test_planned_splits_at_the_serving_shapes_on_132_sms(m, kd, n, k, want):
    _, (bm, bn, bk) = tile_grid(m, n, kd)
    assert split_k(m, n, kd, bm=bm, bn=bn, bk=bk, tk=k_step(k), sms=H100_SMS) == want


def test_resolve_splits_for_the_dd_kernel(monkeypatch):
    _, (bm, bn, bk) = tile_grid(4, 1024, 2816)
    args = dict(bm=bm, bn=bn, bk=bk, tk=k_step(4))  # 88 steps of 32
    assert resolve_splits(None, torch.device("cpu"), 4, 1024, 2816, **args) == 1
    monkeypatch.setattr(limb_ops, "_sm_count", lambda index: H100_SMS)
    assert resolve_splits(None, torch.device("cuda", 0), 4, 1024, 2816, **args) == 8
    assert resolve_splits(88, torch.device("cuda", 0), 4, 1024, 2816, **args) == 88
    for bad in (0, 89):
        with pytest.raises(ValueError, match="splits must lie in"):
            resolve_splits(bad, torch.device("cuda", 0), 4, 1024, 2816, **args)


def test_cpu_wrapper_runs_one_split_by_default():
    a, b = (_t(x) for x in _ab(15, 4, 704, 96))
    default = limb_matmul_dd(a, b, 4, bk=176)
    one = limb_matmul_dd_plain(a, b, 4, bk=176, splits=1)
    assert torch.equal(default[0], one[0]) and torch.equal(default[1], one[1])
    split = limb_matmul_dd(a, b, 4, bk=176, splits=3)
    three = limb_matmul_dd_plain(a, b, 4, bk=176, splits=3)
    assert torch.equal(split[0], three[0]) and torch.equal(split[1], three[1])


def test_out_of_range_splits_raise_before_anything_runs():
    a, b = (_t(x) for x in _ab(16, 4, 200, 16))  # bk clamps to 200: 7 steps of 32
    before = build.launch_counts()
    for bad in (0, 8):
        with pytest.raises(ValueError, match="splits must lie in"):
            limb_matmul_dd(a, b, 4, splits=bad)
        with pytest.raises(ValueError, match="splits must lie in"):
            limb_matmul_dd_plain(a, b, 4, splits=bad)
    assert limb_matmul_dd(a, b, 4, splits=7)[0].shape == (4, 16)
    assert build.launch_counts() == before and build.BUILD_COUNT == 0


def test_cuda_launch_path_checks_operands_before_building():
    a, b = (_t(x) for x in _ab(17, 8, 128, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        limb_ops._launch_dd(a, b, 4, 8, 8, 64, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        limb_ops._launch_dd(a.double(), b, 6, 8, 8, 64, 1)
    assert build.BUILD_COUNT == 0 and build.launch_counts()["limb_matmul_dd"] == 0
