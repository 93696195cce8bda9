"""``tools/dd_variants.py`` on the CPU: its patches still apply.

The tool builds variants of the double-f32 kernel on a GPU from textual
patches of ``csrc/rmpm_gemm.cuh`` and ``csrc/limb_matmul_dd.cu`` (a load
path through a ``cp.async`` ring, and four mutants of the split's reduction
and layout).  A patch whose anchor text has drifted would make the tool
fail on the card, so every patch is applied here to the sources as they
are.  No tolerance: the checks are on source text.
"""
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "dd_variants", os.path.join(ROOT, "tools", "dd_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dd_variants = _tool()


@pytest.mark.parametrize("variant", sorted(dd_variants.PATCHES))
def test_every_patch_applies_once(variant):
    src = dd_variants.read_sources(CSRC)
    out = dd_variants.patch_sources(src, variant)
    assert (out == src) == (variant == "shipped")


def test_the_ring_variant_loads_through_cp_async_and_keeps_the_limb_path():
    src = dd_variants.read_sources(CSRC)
    out = dd_variants.patch_sources(src, "ring")
    gemm, dd = out[dd_variants.GEMM], out[dd_variants.DD]
    shipped = src[dd_variants.GEMM]
    # the shipped DD load path prefetches into registers; the ring variant's
    # copies through the cp.async helpers the header ships for its skinny body
    start = shipped.index(dd_variants.DD_BLOCK_START)
    dd_path = shipped[start:shipped.index(dd_variants.DD_BLOCK_END, start)]
    assert "cp_async" not in dd_path and "extern __shared__" not in dd_path
    assert "cp.async.wait_group" in shipped
    ring = dd_variants.RING_BLOCK
    assert ring in gemm and "cp_async_wait" in ring and "extern __shared__" in ring
    assert "RING_BYTES" in dd and "cudaFuncAttributeMaxDynamicSharedMemorySize" in dd
    # the DD == false load path (limb and mode-map kernels) is left as it is
    tail = shipped[shipped.index(dd_variants.DD_BLOCK_END):]
    assert gemm.endswith(tail)


def test_mutants_touch_only_the_reduction_or_the_ranges():
    src = dd_variants.read_sources(CSRC)
    gemm = src[dd_variants.GEMM]
    reduce_dd = gemm[gemm.index("splitk_reduce_dd("):gemm.index("inline int reduce_blocks")]
    head = gemm[:gemm.index("splitk_reduce_dd(")]
    for variant in ("mut_reverse", "mut_lo_dropped", "mut_plain_add"):
        out = dd_variants.patch_sources(src, variant)
        assert out[dd_variants.DD] == src[dd_variants.DD], variant
        assert out[dd_variants.GEMM].startswith(head), variant
        assert reduce_dd not in out[dd_variants.GEMM], variant
    out = dd_variants.patch_sources(src, "mut_ceil_ranges")[dd_variants.GEMM]
    assert "gridDim.z - 1) / gridDim.z" in out and reduce_dd in out


def test_a_patch_that_no_longer_matches_raises():
    src = {dd_variants.GEMM: "// nothing to patch\n", dd_variants.DD: ""}
    with pytest.raises(ValueError, match="matches 0 times"):
        dd_variants.patch_sources(src, "mut_lo_dropped")
    real = dd_variants.read_sources(CSRC)
    real[dd_variants.GEMM] = real[dd_variants.GEMM].replace(dd_variants.DD_BLOCK_START, "")
    with pytest.raises(ValueError, match="not found exactly once"):
        dd_variants.patch_sources(real, "ring")
