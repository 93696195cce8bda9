"""Everything that depends on the architecture comes from the family the
configuration names (``perfbench/reference/<family>.py``).

* Operations and bytes against shapes worked out by hand.
* The two published configurations read as they did before families
  (``family_readings.json``, recorded from the harness at commit 616b02b,
  where the weights, sizes, work counts and reference were written for
  them alone): the same weights bit for bit, the same sizes and
  ``ArchConfig``, the same work counts and the same reference readings on
  a fixed timeline, float for float.
* A new family is new files and new entries only.
"""
import dataclasses
import hashlib
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import LIMITS, TINY, tiny_root

from harness import check, main, spec, work
from harness.drive import Step, Timeline

HERE = Path(__file__).resolve().parent
BEFORE = json.loads((HERE / "family_readings.json").read_text())
CELLS = ["phi3mini-decode-m16", "phi35moe-decode-m16"]


def family_and_sizes(workload):
    cell = spec.load_cell(workload)
    return cell.family, cell.sizes


def test_phi3_mini_active_parameters():
    fam, sz = family_and_sizes("phi3mini-decode-m16")
    d, f, v = 3072, 8192, 32064
    per_layer = 4 * d * d + 3 * d * f
    assert fam.active_params_per_token(sz) == 32 * per_layer + d * v
    assert fam.active_params_per_token(sz) == pytest.approx(3.72e9, rel=0.01)


def test_phi35_moe_active_parameters_count_top2():
    fam, sz = family_and_sizes("phi35moe-decode-m16")
    d, f, v = 4096, 6400, 32064
    attn = d * (32 + 2 * 8) * 128 + 32 * 128 * d
    per_layer = attn + d * 16 + 2 * 3 * d * f
    assert fam.active_params_per_token(sz) == 8 * per_layer + d * v


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
    dense, dsz = family_and_sizes("phi3mini-decode-m16")
    moe, msz = family_and_sizes("phi35moe-decode-m16")
    assert dense.kernel_sites(dsz) == [
        (32, [(3072, 3072)] * 4 + [(3072, 8192)] * 2 + [(8192, 3072)])]
    assert moe.kernel_sites(msz) == [
        (8, [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096)])]
    one = sum(work.gemm_bound_s(16, k, n, 3) for k, n in dense.kernel_sites(dsz)[0][1])
    assert work.limb_bound_s(dense, dsz, 16, "M16") == pytest.approx(32 * one)


def test_flops_of_a_prefill_and_a_decode_step():
    fam, sz = family_and_sizes("phi3mini-decode-m16")
    n = fam.active_params_per_token(sz)
    attn = 32 * 4 * 32 * 96
    assert work.prefill_flops(fam, sz, 3) == pytest.approx(2 * n * 3 + attn * (1 + 2 + 3))
    assert work.decode_flops(fam, sz, [10, 20]) == pytest.approx(2 * (2 * n) + attn * 30)


# -- the published configurations read as before ---------------------------


def digest(tree) -> str:
    """sha256 over every leaf's path, shape, type and bytes, paths sorted."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        else:
            t = node.detach().cpu().contiguous()
            h.update(f"{path}:{tuple(t.shape)}:{t.dtype}".encode())
            h.update(t.numpy().tobytes())

    walk(tree, "")
    return h.hexdigest()


def tiny_cell(tmp_path, moe):
    return spec.load_cell("tiny-cell", tiny_root(tmp_path, moe=moe, kind="closed_loop"))


def fixed_timeline(vocab: int) -> Timeline:
    """Four requests over three slots: rows in changing orders, one request
    finishing and another admitted in its place; every decode step holds
    every slot.  Prompts and served tokens drawn from a fixed seed."""
    rng = np.random.default_rng(20261018)
    tl = Timeline(t_open=0.5, t_close=100.0)
    lens = {0: 5, 1: 7, 2: 4, 3: 6}
    schedule = [([0, 1, 2], []), ([], [0, 1, 2]), ([], [2, 0, 1]), ([3], []),
                ([], [0, 2, 3]), ([], [3, 2, 0]), ([], [2, 3, 0])]
    for rid in lens:
        n_tok = 1 + sum(rid in d for _, d in schedule)
        tl.prompts[rid] = rng.integers(0, vocab, lens[rid]).astype(np.int32)
        tl.tokens[rid] = [int(t) for t in rng.integers(0, vocab, n_tok)]
        tl.max_new[rid] = n_tok
    for i, (adm, dec) in enumerate(schedule):
        tl.steps.append(Step(float(i), i + 0.9, adm, dec))
    return tl


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_weights_are_drawn_as_before(tmp_path, moe):
    cell = tiny_cell(tmp_path, moe)
    got = {str(s): digest(cell.family.weights(cell.sizes, s, "cpu")) for s in (2**31 + 7, 11)}
    assert got == BEFORE[f"tiny_{'moe' if moe else 'dense'}_digest"]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_the_reference_reads_as_before(tmp_path, one_thread, moe):
    """The same requests judged, and the same gaps, on a fixed timeline."""
    cell = tiny_cell(tmp_path, moe)
    fam, sz = cell.family, cell.sizes
    key = "moe" if moe else "dense"
    tl = fixed_timeline(sz.vocab)
    coupled = fam.coupled_rows(sz)
    assert coupled == moe
    assert sorted(check.judged(tl, coupled, 2, 2**31 + 3)) == BEFORE[f"tiny_{key}_judged"]
    rep = fam.Replay(sz, fam.weights(sz, 5, "cpu"), 3, 32, "cpu")
    assert check.readings(tl, rep, coupled, 3, {0, 1, 2, 3}, "cpu") == BEFORE[
        f"tiny_{key}_readings"]


@pytest.mark.parametrize("workload", CELLS)
def test_sizes_and_arch_are_as_before(workload):
    cell = spec.load_cell(workload)
    before = BEFORE[workload]
    sz = cell.sizes
    assert {f.name: getattr(sz, f.name) for f in dataclasses.fields(sz)} == before["sizes"]
    arch = spec.arch_of(cell)
    assert {f.name: repr(getattr(arch, f.name)) for f in dataclasses.fields(arch)} == before[
        "arch"]
    assert repr(spec.arch_of(cell, "M8", "native").policy) == before["arch_m8_native"]


@pytest.mark.parametrize("workload", CELLS)
def test_work_counts_are_as_before(workload):
    cell = spec.load_cell(workload)
    fam, sz, before = cell.family, cell.sizes, BEFORE[workload]
    assert fam.active_params_per_token(sz) == before["active_params_per_token"]
    assert work.limb_bound_s(fam, sz, 16, "M16") == before["limb_bound_s"]
    assert work.decode_flops(fam, sz, [161, 600, 2048]) == before["decode_flops"]
    assert work.prefill_flops(fam, sz, 161) == before["prefill_flops"]
    assert fam.kernel_sites(sz) == [(sz.n_layers, [tuple(s) for s in before["kernel_sites"]])]


# -- a new family is new files only ----------------------------------------


def add_family_cell(root: Path, family: str) -> None:
    """A configuration naming ``family``, a cell ``fam-cell`` over the tiny
    closed loop and its limits, as new files and new entries."""
    cfg = dict(TINY, name="fam", reference=family, num_hidden_layers=3, num_local_experts=4,
               num_experts_per_tok=2, first_k_dense_replace=1, n_shared_experts=1)
    (root / "perfbench/configs/fam.json").write_text(json.dumps(cfg))
    (root / "perfbench/cells/fam-cell.json").write_text(json.dumps({"limits": LIMITS[True]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fam", "source": "test", "reduced": [], "why": "test",
                             "file": "perfbench/configs/fam.json"})
    bench["workloads"].append({"name": "fam-cell", "config": "fam", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_family_is_new_files_only(tmp_path):
    """A family of another structure (a leading dense layer, then MoE layers
    with a shared expert: ``seg0_dense`` + ``seg1_moe``) runs to ``correct``
    with the harness copied byte for byte."""
    root = tiny_root(tmp_path, moe=True, kind="closed_loop")
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    for name in ("dense_then_moe.py", "dense_then_moe_arch.py"):
        shutil.copy(HERE / "families" / name, root / "perfbench/reference" / name)
    add_family_cell(root, "dense_then_moe")
    cell = spec.load_cell("fam-cell", root)
    cell.traffic["judge_requests"] = 10**6
    arch = spec.arch_of(cell)
    assert (arch.moe_first_dense, arch.moe_shared_experts, arch.n_layers) == (1, 1, 3)
    seed = 2**31 + 21
    run, params, _ = main.serve(cell, seed, 1.5, True, "cpu", time.perf_counter())
    assert list(params["layers"]) == ["seg0_dense", "seg1_moe"]
    main.report(run, True)
    # no metric lists the new cell; its reader runs on the family's counts
    assert spec.metric_reader(cell, "mfu.decode").read(run) > 0
    ok, got = main.judge(run, params, seed, "cpu")
    assert ok, got
    assert got["tokens_judged"]["value"] > 10
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_a_missing_family_names_its_file(tmp_path):
    root = tiny_root(tmp_path, moe=True, kind="closed_loop")
    add_family_cell(root, "no_such_family")
    with pytest.raises(SystemExit, match=r"reference/no_such_family\.py"):
        spec.load_cell("fam-cell", root)
