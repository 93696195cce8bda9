"""The shard-wise paths of the port's model and train code on four gloo
ranks (``torch_dist_ranks.py shardwise``, which imports neither JAX nor the
reference), each against the unsharded run on the same inputs:

* ``train.step._microbatch``: the microbatches of a batch sharded over
  'data' hold its rows in order and keep its layout; a step of two
  microbatches, data-parallel (qwen) and sequence-parallel with FSDP
  (qwen1.5-4b), where ``core.rmpm._einsum`` gathers the weight;
* ``sharding.split_dim``: a head count the model axis does not divide is
  gathered first, one it divides is split shard by shard;
* cached decode with a shared length (``layers._put_local``'s KV writes,
  ``_flash_attention_on_shards`` with its offset, positions and int8
  scales), on qwen with bf16 and int8 KV and on the hybrid arch's
  local-window cache and recurrent states;
* a train step of mamba2 (its SSD einsums, ``_pad_sequence`` of the causal
  conv) and recurrentgemma (``griffin._logsigmoid``, one KV head over a
  2-wide model axis).

The bounds are ``test_torch_distributed.py``'s: ``SHARDED_LOSS_TOL`` in
loss (the reference's own, ``tests/test_distributed.py``), 1e-5 relative
in gradient norm, ``GRAD_TOL`` per gradient leaf over its scale.  A decode
step's logits are held to ``DECODE_TOL`` over their scale: the f32 sums of
a sharded step run in other orders, and a cached K or V element that lands
on the other side of a bf16 (or int8) rounding step moves the logits by up
to one quantum of that cache times the attention weight it carries.
"""
import os

import numpy as np
import pytest

from test_torch_common import spawn_ranks

SHARDED_LOSS_TOL = 5e-4
GRAD_TOL = 2.0**-14
#: one bf16 quantum (2^-8) of a cached element: the largest logit move a
#: rounding flip of the sharded step's K or V can make, over the logits' scale
DECODE_TOL = 2.0**-8
WORLD = 4
ARCHS = ("qwen1.5-0.5b", "qwen1.5-4b", "mamba2-2.7b", "recurrentgemma-9b")


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shardwise")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (8, 33)).astype(np.int32)
    np.savez(os.path.join(d, "inputs.npz"), tokens=toks[:, :-1].copy(),
             labels=toks[:, 1:].copy(),
             split_x=rng.standard_normal((6, 64)).astype(np.float32))
    return spawn_ranks("shardwise", WORLD, d, timeout=300.0)


def test_microbatches_of_a_sharded_batch_keep_row_order_and_layout(outs):
    for out in outs:
        assert out["micro_rows"] and out["micro_placements"], out


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_within_the_bound_of_the_unsharded_step(outs, arch):
    for out in outs:
        rec = out[f"step_{arch}"]
        assert rec["accum_steps"] == (2 if arch.startswith("qwen") else 1)
        (plain, sharded), (gn, sgn) = rec["loss"], rec["grad_norm"]
        assert abs(sharded - plain) < SHARDED_LOSS_TOL, rec
        assert abs(sgn - gn) <= 1e-5 * gn, rec
        assert rec["grad_gap"] <= GRAD_TOL, rec
    assert all(o[f"step_{arch}"] == outs[0][f"step_{arch}"] for o in outs)


def test_split_dim_gathers_only_an_undivided_head_count(outs):
    for out in outs:
        assert out["split_equal"] and out["split4_equal"], out
        assert out["split4_placements"] == "(Shard(dim=1),)"


@pytest.mark.parametrize("case", ["decode_qwen_bf16", "decode_qwen_int8", "decode_rg_bf16"])
def test_sharded_cached_decode_matches_the_unsharded_decode(outs, case):
    for out in outs:
        rec = out[case]
        assert rec["steps"] == 5
        assert rec["gap"] <= DECODE_TOL, rec
    rec = outs[0][case]
    want = "torch.int8" if case.endswith("int8") else "torch.bfloat16"
    assert rec["kv_dtypes"] == [want]
    assert (rec["scales"] > 0) == case.endswith("int8"), rec
    # the batch rows sharded over 'data'
    assert all("Shard(dim=0)" in p for p in rec["kv_placements"]), rec
