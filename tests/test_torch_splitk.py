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
import importlib.util
import inspect
import os

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
    SKINNY_M_MAX,
    THREAD_TILE,
    gemm_blocks,
    gemm_body,
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
    """The S the limb and mode-map wrappers plan on the card."""
    _, (bm, bn, bk) = tile_grid(m, n, kd, **blk)
    return split_k(m, n, kd, bm=bm, bn=bn, bk=bk, tk=k_step(k), sms=sms,
                   body=gemm_body(m, k))


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
    for body in ("wide", "skinny", "mma"):
        s = split_k(m, n, kd, bm=bm, bn=bn, bk=bk, tk=tk, sms=sms, body=body)
        blocks = gemm_blocks(m, n, bm, bn, body)
        per_sm = BLOCKS_PER_SM[body]
        assert 1 <= s <= k_steps(kd, bk, tk)
        # the grid alone fills the card (blocks > sms at two blocks an SM)
        if 2 * blocks > per_sm * sms:
            assert s == 1
        else:
            assert s == min(per_sm * sms // blocks, k_steps(kd, bk, tk))
        assert blocks * s <= max(per_sm * sms, blocks)


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
    body = gemm_body(m, 3)
    fill = BLOCKS_PER_SM[body] * H100_SMS // gemm_blocks(m, n, bm, bn, body)
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
    (4, 1024, 1024, 16), (4, 2816, 1024, 24), (4, 1024, 2816, 9),
    (48, 1024, 1024, 16), (48, 2816, 1024, 16), (48, 1024, 2816, 6),
    (1024, 1024, 1024, 1), (4096, 4096, 4096, 1)])
def test_planned_splits_at_the_serving_and_tuner_shapes_on_132_sms(m, kd, n, want):
    """M = 48: (N / 128) blocks of the tensor-core tile body, one an SM
    (8 blocks -> S = 16 at N = 1024, 22 -> 6 at N = 2816); 1024 and 4096
    rows fill the card with their 64 x 128 blocks alone."""
    assert _plan(m, kd, n) == want


def test_resolve_splits(monkeypatch):
    args = dict(bm=8, bn=128, bk=512, tk=64)
    assert resolve_splits(None, torch.device("cpu"), 4, 1024, 2816, **args) == 1
    assert resolve_splits(5, torch.device("cpu"), 4, 1024, 2816, **args) == 5
    monkeypatch.setattr(limb_ops, "_sm_count", lambda index: H100_SMS)
    # (m, n, kdim) = (4, 1024, 2816): 32 blocks, 44 steps
    assert resolve_splits(None, torch.device("cuda", 0), 4, 1024, 2816, **args) == 8
    # the skinny body's 16 x 64 tile: 16 blocks, three an SM
    assert resolve_splits(None, torch.device("cuda", 0), 4, 1024, 2816, **args,
                          body="skinny") == 24
    assert resolve_splits(2, torch.device("cuda", 0), 4, 1024, 2816, **args) == 2
    for bad in (0, 45):
        with pytest.raises(ValueError, match="splits must lie in"):
            resolve_splits(bad, torch.device("cuda", 0), 4, 1024, 2816, **args)


# ---------------------------------------------------------------------------
# the two bodies: the route by M and the Python mirror of the header
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_ROWS = (1, 4, 8, 16, 17)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@functools.lru_cache(maxsize=None)
def _held_kn():
    """Every (K, N) ``chip_smoke.py`` holds the limb and mode-map kernels at:
    the serving model's, the hybrid's and every other family's."""
    cs = _chip_smoke()
    return sorted(set(cs.MAIN_KN) | set(cs.HYBRID_KN)
                  | {kn for _, kns in cs.FAMILY_SHAPES.values() for kn in kns})


@settings(max_examples=200, deadline=None)
@given(st.sampled_from(DECODE_ROWS), st.integers(0, 10**6), st.integers(1, 200))
def test_split_k_at_decode_rows_is_the_same_at_every_ladder_limb_count(m, pick, sms):
    """At M in {1, 4, 8, 16, 17} over every held (K, N): one body for the
    whole f32 ladder (the skinny one up to M = 16, the tensor-core tile one
    above), one K step, one S, and S inside the walk and the body's fill of
    the card."""
    kn = _held_kn()
    kd, n = kn[pick % len(kn)]
    assert len({gemm_body(m, k) for k in (1, 2, 3)}) == 1
    body = gemm_body(m, 1)
    assert body == ("skinny" if m <= SKINNY_M_MAX else "mma")
    plans = {_plan(m, kd, n, k, sms=sms) for k in (1, 2, 3)}
    assert len(plans) == 1
    s = plans.pop()
    _, (bm, bn, bk) = tile_grid(m, n, kd)
    steps = k_steps(kd, bk, k_step(3))
    assert 1 <= s <= steps
    fill = BLOCKS_PER_SM[body] * sms // gemm_blocks(m, n, bm, bn, body)
    assert s == max(1, min(max(fill, -(-kd // MAX_SPLIT_LEN)), steps))


@pytest.mark.parametrize("m", DECODE_ROWS + (48,))
def test_the_ladder_keeps_one_k_step_and_wider_modes_the_tiled_body(m):
    assert {k_step(k) for k in (1, 2, 3)} == {64}
    assert {gemm_body(m, k) for k in (4, 5, 6)} == {"wide"}
    assert k_step(4) == 32


@settings(max_examples=200, deadline=None)
@given(st.integers(SKINNY_M_MAX + 1, 2048), st.integers(0, 10**6))
def test_m_above_16_runs_the_tensor_core_tile_body_on_the_ladder(m, pick):
    """M in 17..2048: the limb and mode-map kernels run the tensor-core tile
    body at every f32-ladder limb count, with one S for the ladder read from
    that body's tile and residency; 4-6 limbs and the double-f32 kernel (the
    wrapper's default body) keep the tiled one."""
    assert {gemm_body(m, k) for k in (1, 2, 3)} == {"mma"}
    assert {gemm_body(m, k) for k in (4, 5, 6)} == {"wide"}
    kn = _held_kn()
    kd, n = kn[pick % len(kn)]
    _, (bm, bn, bk) = tile_grid(m, n, kd)
    plans = {_plan(m, kd, n, k) for k in (1, 2, 3)}
    steps = k_steps(kd, bk, k_step(3))
    fill = BLOCKS_PER_SM["mma"] * H100_SMS // gemm_blocks(m, n, bm, bn, "mma")
    assert plans == {max(1, min(max(fill, -(-kd // MAX_SPLIT_LEN)), steps))}
    # the double-f32 wrapper plans with the tiled body's tile
    assert inspect.signature(resolve_splits).parameters["body"].default == "wide"


def _header_constants():
    """The text of ``rmpm_gemm.cuh`` and its ``constexpr int`` constants, as
    ``chip_smoke.py`` reads them for its ``kernels`` line."""
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc", "rmpm_gemm.cuh")) as fh:
        text = fh.read()
    return text, _chip_smoke().header_constants()


def test_the_python_mirror_matches_the_header():
    text, c = _header_constants()
    assert c["SKINNY_M_MAX"] == SKINNY_M_MAX == 16
    assert THREAD_TILE == {"wide": (c["TM"], c["TN"]), "skinny": (c["SK_TM"], c["SK_TN"]),
                           "mma": (c["MM_TM"], c["MM_TN"])}
    assert BLOCKS_PER_SM["skinny"] == c["SK_BLOCKS_PER_SM"]
    assert BLOCKS_PER_SM["mma"] == c["MM_BLOCKS_PER_SM"]
    assert c["SK_TK"] == c["MM_TK"] == k_step(3)
    assert "static constexpr int TK = (KMAX <= 3) ? 64 : 32;" in text
    # the route: M only on the ladder, as gemm_body
    assert "inline bool use_skinny(int M, int limbs) { return M <= SKINNY_M_MAX && limbs <= 3; }" \
        in text
    assert "inline bool use_mma(int M, int limbs) { return M > SKINNY_M_MAX && limbs <= 3; }" \
        in text
    # the ring leaves room for the blocks split_k counts on an SM (228 KB),
    # and its strides keep the copies 16-byte aligned
    assert c["SK_BLOCKS_PER_SM"] * (c["SK_SMEM_BYTES"] + 1024) <= 228 * 1024
    assert c["SK_SMEM_BYTES"] > 48 * 1024  # hence the per-device opt-in
    assert c["SK_B_LD"] % 4 == 0 and c["SK_A_LD"] % 4 == 0 and c["SK_STAGE_FLOATS"] % 4 == 0
    # the fragment reads hit 32 distinct banks: rows 2t (t < 4) x columns
    # g (g < 8) of B's stage; rows g x float2 columns 2t of A's, per half-warp
    assert len({(2 * t * c["SK_B_LD"] + g) % 32 for t in range(4) for g in range(8)}) == 32
    assert len({(g * c["SK_A_LD"] + 2 * t + e) % 32
                for t in range(4) for g in range(4) for e in range(2)}) == 32
    # the tensor-core tile body: eight warps of 32 x 32 (2 x 4 m16n8
    # fragments) over its 64 x 128 block; a raw ring of at least three stages
    # (two K steps in flight) and three limb planes within the 227 KB a block
    # may use, one block an SM with the runtime's 1 KB; 16-byte-aligned
    # stages, planes and plane rows (ldmatrix reads 16-byte rows)
    assert (c["MM_TM"], c["MM_TN"]) == (32 * c["MM_WARPS_M"], 32 * c["MM_WARPS_N"]) == (64, 128)
    assert c["MM_THREADS"] == 32 * 8
    assert c["MM_STAGES"] >= 3 and c["MM_LIMBS"] == 3
    assert c["MM_STAGE_FLOATS"] == c["MM_TM"] * c["MM_TK"] + c["MM_TK"] * c["MM_TN"]
    assert c["MM_PLANE_ELEMS"] == c["MM_TM"] * c["MM_A_PL"] + c["MM_TK"] * c["MM_B_PL"]
    assert c["MM_SMEM_BYTES"] == (c["MM_STAGES"] * c["MM_STAGE_FLOATS"] * 4
                                  + c["MM_LIMBS"] * c["MM_PLANE_ELEMS"] * 2)
    assert 48 * 1024 < c["MM_SMEM_BYTES"] <= 227 * 1024
    assert c["MM_BLOCKS_PER_SM"] * (c["MM_SMEM_BYTES"] + 1024) <= 228 * 1024
    assert c["MM_STAGE_FLOATS"] % 4 == 0 and c["MM_PLANE_ELEMS"] % 8 == 0
    assert c["MM_A_PL"] % 8 == 0 and c["MM_B_PL"] % 8 == 0
    assert c["MM_A_PL"] >= c["MM_TK"] and c["MM_B_PL"] >= c["MM_TN"]
    # conflict-free ldmatrix: the eight 16-byte rows of an 8 x 8 read (A's
    # rows of K, B's rows of N) fall in eight distinct 16-byte bank groups
    for ld in (c["MM_A_PL"], c["MM_B_PL"]):
        assert len({(r * ld * 2 // 16) % 8 for r in range(8)}) == 8
    # and the peel's float4 reads and 8-byte plane stores: a half-warp's
    # sixteen consecutive chunks of a row are contiguous
    assert c["MM_TK"] % 64 == 0 and c["MM_TN"] % 64 == 0
    # the launch bounds hold each body to the residency split_k counts
    for body in ("limb_matmul", "tile_matmul"):
        with open(os.path.join(ROOT, "src", "repro_torch", "csrc", f"{body}.cu")) as fh:
            assert "__launch_bounds__(rmpm::MM_THREADS, rmpm::MM_BLOCKS_PER_SM)" in fh.read()


def test_chip_smoke_reads_every_mma_instantiation_from_ptxas():
    """The ``kernels`` line's ptxas record of the tensor-core tile body: its
    six kernels (limb and map, KMAX 1-3) with their registers and spills,
    the skinny and tiled ones left out, and the ring's dynamic shared memory
    from the header."""
    cs = _chip_smoke()
    entry = "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__{}' for 'sm_90a'"
    lines = []
    for i, (kind, kmax) in enumerate((kind, kmax) for kind in ("limb", "tile")
                                     for kmax in (1, 2, 3)):
        sig = "EEvPKfS2_Pfiiiiii" if kind == "limb" else "EEvPKfS2_PfPKiiiiiiii"
        lines += [entry.format(f"{kind}_matmul_mma_kernelILi{kmax}{sig}"),
                  f"    0 bytes stack frame, {i} bytes spill stores, {3 * i} bytes spill loads",
                  f"ptxas info    : Used {200 + i} registers, used 1 barriers"]
    lines += [entry.format("limb_matmul_skinny_kernelILi3ELi2EEEvPKfS2_Pfiiiiii"),
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
              "ptxas info    : Used 168 registers, used 1 barriers",
              entry.format("limb_matmul_kernelILi4EEEvPKfS2_Pfiiiiii"),
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
              "ptxas info    : Used 138 registers, used 1 barriers, 25088 bytes smem"]
    got = cs.body_ptxas("\n".join(lines), "mma")
    _, consts = _header_constants()
    assert len(got) == 6
    assert [(g["kernel"], g["kmax"]) for g in got] == [
        (f"{kind}_matmul", k) for kind in ("limb", "tile") for k in (1, 2, 3)]
    assert [g["registers"] for g in got] == [200 + i for i in range(6)]
    assert [(g["spill_stores"], g["spill_loads"]) for g in got] == [(i, 3 * i) for i in range(6)]
    assert {g["static_smem_bytes"] for g in got} == {0}
    assert {g["dynamic_smem_bytes"] for g in got} == {consts["MM_SMEM_BYTES"]}
    assert "nf" not in got[0]
    assert len(cs.body_ptxas("\n".join(lines), "skinny")) == 1


def test_chip_smoke_reads_every_skinny_instantiation_from_ptxas():
    """The ``kernels`` line's ptxas record: the twelve skinny kernels (limb
    and map, KMAX 1-3, NF 1-2) with their registers and spills, the tiled
    ones left out, and the ring's dynamic shared memory from the header."""
    cs = _chip_smoke()
    entry = "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__{}' for 'sm_90a'"
    lines = []
    for i, (kind, kmax, nf) in enumerate((kind, kmax, nf) for kind in ("limb", "tile")
                                         for kmax in (1, 2, 3) for nf in (1, 2)):
        lines += [entry.format(f"{kind}_matmul_skinny_kernelILi{kmax}ELi{nf}EEEvPKfS2_Pf"),
                  f"    0 bytes stack frame, {i} bytes spill stores, {2 * i} bytes spill loads",
                  f"ptxas info    : Used {100 + i} registers, used 1 barriers"]
    lines += [entry.format("limb_matmul_kernelILi3EEEvPKfS2_Pfiiiiii"),
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
              "ptxas info    : Used 255 registers, used 1 barriers, 33792 bytes smem"]
    got = cs.body_ptxas("\n".join(lines), "skinny")
    _, consts = _header_constants()
    assert len(got) == 12
    assert {g["kernel"] for g in got[:6]} == {"limb_matmul"}
    assert {g["kernel"] for g in got[6:]} == {"tile_matmul"}
    assert [(g["kmax"], g["nf"]) for g in got[:6]] == [(k, f) for k in (1, 2, 3) for f in (1, 2)]
    assert [g["registers"] for g in got] == [100 + i for i in range(12)]
    assert [g["spill_loads"] for g in got] == [2 * i for i in range(12)]
    assert {g["static_smem_bytes"] for g in got} == {0}
    assert {g["dynamic_smem_bytes"] for g in got} == {consts["SK_SMEM_BYTES"]}


@pytest.mark.parametrize("m,kd,n,want", [
    (1, 1024, 1024, 16), (4, 4096, 12288, 2), (4, 12288, 33792, 1), (4, 33792, 12288, 3),
    (8, 4096, 1024, 24),
    (16, 1024, 1024, 16), (17, 1024, 1024, 16)])
def test_planned_splits_of_each_body_on_132_sms(m, kd, n, want):
    """M <= 16: (M/bm) x (N / 64) blocks of the skinny body, three an SM;
    M = 17: the tensor-core tile body's 64 x 128 blocks, one an SM."""
    assert _plan(m, kd, n) == want


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


def test_launches_are_counted_by_body_only_where_a_kernel_launches():
    """``build.BODY_LAUNCHES`` names every body ``split_k`` knows; the CPU's
    plain versions launch nothing, so neither count moves, and a reset
    zeroes both."""
    assert set(build.BODY_LAUNCHES) == set(THREAD_TILE) == set(BLOCKS_PER_SM)
    build.BODY_LAUNCHES["mma"] += 1
    build.reset_launch_counts()
    assert build.body_launch_counts() == {body: 0 for body in THREAD_TILE}
    a, b = (_t(x) for x in _ab(10, 20, 128, 24))
    limb_matmul(a, b, 2)
    tile_matmul_runtime(a, b, 2)
    limb_ops.limb_matmul_dd(a, b, 4)
    assert build.body_launch_counts() == {body: 0 for body in THREAD_TILE}
    assert sum(build.launch_counts().values()) == 0


def test_cuda_launch_paths_check_operands_before_building():
    a, b = (_t(x) for x in _ab(9, 8, 128, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        limb_ops._launch(a, b, 3, 8, 8, 64, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tile_ops._launch(a, b, torch.ones((1, 1), dtype=torch.int32), 3, 8, 8, 64, 2)
    assert build.BUILD_COUNT == 0
