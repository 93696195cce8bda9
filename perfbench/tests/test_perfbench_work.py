"""Operations and bytes against shapes worked out by hand."""
import pytest

from harness import spec, work


def test_phi3_mini_active_parameters():
    sz = spec.load_cell("phi3mini-decode-m16").sizes
    d, f, v = 3072, 8192, 32064
    per_layer = 4 * d * d + 3 * d * f
    assert work.active_params_per_token(sz) == 32 * per_layer + d * v
    assert work.active_params_per_token(sz) == pytest.approx(3.72e9, rel=0.01)


def test_phi35_moe_active_parameters_count_top2():
    sz = spec.load_cell("phi35moe-decode-m16").sizes
    d, f, v = 4096, 6400, 32064
    attn = d * (32 + 2 * 8) * 128 + 32 * 128 * d
    per_layer = attn + d * 16 + 2 * 3 * d * f
    assert work.active_params_per_token(sz) == 8 * per_layer + d * v


def test_limb_bound_by_hand():
    # M16: three passes.  A 16 x 3072 x 8192 launch: 2.42e9 FLOPs (2.4 us at
    # 989 TFLOP/s) against 100.9 MB of f32 operands (30.1 us): bytes bound
    assert work.mode_passes("M16") == 3 and work.mode_passes("M8") == 1
    flops, nbytes = work.gemm_work(16, 3072, 8192, 3)
    assert flops == 3 * 2 * 16 * 3072 * 8192
    assert nbytes == 4 * (16 * 3072 + 3072 * 8192 + 16 * 8192)
    assert work.gemm_bound_s(16, 3072, 8192, 3) == pytest.approx(nbytes / 3.35e12)
    # a 768-row prefill of the same site is bound by operations
    assert work.gemm_bound_s(768, 3072, 8192, 3) == pytest.approx(
        3 * 2 * 768 * 3072 * 8192 / 989e12)


def test_limb_sites_per_layer():
    dense = spec.load_cell("phi3mini-decode-m16").sizes
    moe = spec.load_cell("phi35moe-decode-m16").sizes
    assert work.kernel_sites(dense) == [(3072, 3072)] * 4 + [(3072, 8192)] * 2 + [(8192, 3072)]
    assert work.kernel_sites(moe) == [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096)]
    one = sum(work.gemm_bound_s(16, k, n, 3) for k, n in work.kernel_sites(dense))
    assert work.limb_bound_s(dense, 16, "M16") == pytest.approx(32 * one)


def test_flops_of_a_prefill_and_a_decode_step():
    sz = spec.load_cell("phi3mini-decode-m16").sizes
    n = work.active_params_per_token(sz)
    attn = 32 * 4 * 32 * 96
    assert work.prefill_flops(sz, 3) == pytest.approx(2 * n * 3 + attn * (1 + 2 + 3))
    assert work.decode_flops(sz, [10, 20]) == pytest.approx(2 * (2 * n) + attn * 30)
