"""The reference against the port, and the check against its faults, at
tiny Phi-3 and Phi-3.5-MoE sizes on the CPU.

Each run drives the harness's own set-up, window and check (``serve`` and
``judge``) on a tiny cell, with the look for a card skipped."""
import time

import pytest
import torch
from conftest import TINY, tiny_root

import faults

from harness import main, spec


def run_cell(tmp_path, *, moe, kind, mode=None, seconds=1.5, seed=2**31 + 7, judge_all=True):
    cell = spec.load_cell("tiny-cell", tiny_root(tmp_path, moe=moe, kind=kind))
    if judge_all:
        cell.traffic["judge_requests"] = 10**6
    run, params, _ = main.serve(cell, seed, seconds, False, "cpu", time.perf_counter(),
                                mode=mode)
    return main.judge(run, params, seed, "cpu")


@pytest.mark.parametrize("moe,kind", [(False, "closed_loop"), (False, "poisson"),
                                      (True, "closed_loop")])
def test_port_agrees_with_the_reference(tmp_path, moe, kind):
    ok, got = run_cell(tmp_path, moe=moe, kind=kind)
    assert ok, got
    assert got["tokens_judged"]["value"] > 10


@pytest.mark.parametrize("moe,number", [(False, "widest_logit_gap"), (True, "off_best_share")])
def test_m8_control_reads_far_wider(tmp_path, moe, number):
    _, m16 = run_cell(tmp_path / "a", moe=moe, kind="closed_loop", seconds=6.0)
    _, m8 = run_cell(tmp_path / "b", moe=moe, kind="closed_loop", mode="M8", seconds=6.0)
    assert m8[number]["value"] > 3 * max(m16[number]["value"], 1e-3 if moe else 1e-5)


def test_reference_moe_drops_past_capacity():
    """Four tokens all preferring expert 0 at capacity 1: only the first
    keeps it (k-major, then by token)."""
    from reference.gqa import Sizes, capacity, moe

    sz = Sizes(n_layers=1, d_model=4, n_heads=1, n_kv_heads=1, d_ff=4, vocab=8, head_dim=4,
               experts=4, top_k=1, capacity_factor=1.0)
    assert capacity(4, sz) == 1
    router = torch.zeros(4, 4)
    router[:, 0] = 10.0
    p = {"router": {"w": router}, "gate": torch.ones(4, 4, 4), "up": torch.ones(4, 4, 4),
         "down": torch.ones(4, 4, 4)}
    out = moe(p, torch.ones(4, 4), sz, group=4)
    assert (out[0] != 0).all() and (out[1:] == 0).all()


# -- faults planted under the timed path: each must come out not correct --


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_faults_come_out_not_correct(tmp_path, moe, fault):
    with faults.planted(fault, TINY["vocab_size"]):
        ok, got = run_cell(tmp_path, moe=moe, kind="closed_loop")
    assert not ok, got


def test_judged_holds_every_slot_at_the_open(tmp_path):
    """A dense cell's sample holds each request that had a slot when the
    window opened, however few the mix asks for."""
    from harness import check

    cell = spec.load_cell("tiny-cell", tiny_root(tmp_path, moe=False, kind="closed_loop"))
    run, _, _ = main.serve(cell, 2**31 + 9, 1.5, False, "cpu", time.perf_counter())
    tl = run.timeline
    first = next(st for st in tl.steps if st.t0 >= tl.t_open)
    assert len(first.decode) == cell.traffic["slots"]
    rids = check.judged(tl, cell.family.coupled_rows(run.sizes), 1, 2**31 + 9)
    assert set(first.decode) <= rids and len(rids) == cell.traffic["slots"] + (
        max(tl.tokens, key=lambda r: (len(tl.tokens[r]), -r)) not in first.decode)


def test_half_batch_is_caught_by_the_sample(tmp_path):
    """The fault that breaks the upper half of the slots is caught when the
    check judges no more than the mix's sample."""
    with faults.planted("half_batch", TINY["vocab_size"]):
        ok, got = run_cell(tmp_path, moe=False, kind="closed_loop", judge_all=False)
    assert not ok, got
