"""Gradient compression over 'pod', the GPipe pipeline and the elastic
restore on four gloo ranks on the CPU (``torch_dist_ranks.py``, which
imports neither JAX nor the reference), held against the reference's
functions run here on the same numpy inputs.

* Compression on a (2, 1, 2) ('pod', 'data', 'model') mesh: the int8
  codes and f32 scales equal the reference's ``_quantize_block`` bit for
  bit; the mean over pods and the new residual equal the reference's
  arithmetic on those codes bit for bit; a replicated gradient comes back
  within 1.01 x max|g| / 127 with the residual g - reduced within 1e-6
  (the reference's ``test_compressed_psum_pod_numerics``); only int8 codes
  and f32 scales cross 'pod' (``compress.pod_traffic``, the counterpart of
  ``test_compressed_collective_is_int8_in_hlo``), each rank sending its own
  share; a DTensor leaf laid out by rows, by columns or replicated reduces
  to the reference's result on the whole tensors, bit for bit; a
  ``grad_compression`` train step lowers the loss.
* The pipeline at S = 4 stages and M = 6 microbatches against the
  sequential stack: rtol 2e-5 / atol 2e-6 forward, rtol 2e-4 / atol 2e-5
  for the gradient (the reference's tolerances), ``bubble_fraction(4, 6)``
  = 3/9.
* A checkpoint saved from a (4,) mesh with ``Shard(0)`` is restored onto a
  (2, 2) mesh with the leaf on 'model'; the reference's manager reads the
  port's directory and the port reads the reference's onto the mesh.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.policy import PRESETS as J_POLICIES
from repro.distributed import compress as jcompress
from repro.distributed.pipeline import bubble_fraction as j_bubble_fraction
from repro.models import build_model as j_build_model

from test_torch_common import flat_numpy, numpy_params, spawn_ranks

WORLD = 4
SHARDED_LOSS_TOL = 5e-4
S, M, B, D = 4, 6, 2, 16


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod")
    rng = np.random.default_rng(0)
    cfg = j_get_smoke_config("qwen1.5-0.5b").with_policy(J_POLICIES["native_f32"])
    params = numpy_params(j_build_model(cfg), 0)
    toks = rng.integers(0, cfg.vocab, (8, 33)).astype(np.int32)
    inputs = {
        "g_rep": rng.standard_normal(1024).astype(np.float32),
        # 1000 elements: the last block is padded
        "g_pod0": rng.standard_normal(1000).astype(np.float32),
        "g_pod1": (rng.standard_normal(1000) * 3).astype(np.float32),
        "r_pod0": (rng.standard_normal(1000) * 0.01).astype(np.float32),
        "r_pod1": (rng.standard_normal(1000) * 0.01).astype(np.float32),
        # a (24, 40) leaf, laid out three ways on the pod-free mesh
        "g2_pod0": rng.standard_normal((24, 40)).astype(np.float32),
        "g2_pod1": (rng.standard_normal((24, 40)) * 2).astype(np.float32),
        "r2_pod0": (rng.standard_normal((24, 40)) * 0.01).astype(np.float32),
        "r2_pod1": (rng.standard_normal((24, 40)) * 0.01).astype(np.float32),
        "pipe_w": (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
        "pipe_x": rng.standard_normal((M, B, D)).astype(np.float32),
        "tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
        **flat_numpy(params, "params"),
    }
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    JCheckpointManager(os.path.join(d, "ref_ckpt"), async_save=False).save(
        3, {"x": jnp.arange(64.0) * 2, "opt": {"step": jnp.int32(3)}})
    return d, inputs, spawn_ranks("pod", WORLD, d)


def _pod_of(rank: int) -> int:
    return rank // 2  # (pod, data, model) = (2, 1, 2), rank-major


def test_compressed_psum_pod_numerics(pod_run):
    _, _, outs = pod_run
    for out in outs:
        assert out["rep_err"] <= out["rep_bound"] * 1.01, out
        assert out["rep_residual_gap"] <= 1e-6


def test_int8_codes_equal_the_references(pod_run):
    d, inputs, _ = pod_run
    for r in range(WORLD):
        p = _pod_of(r)
        corrected = jnp.asarray(inputs[f"g_pod{p}"]) + jnp.asarray(inputs[f"r_pod{p}"])
        q, s = jcompress._quantize_block(corrected)
        got_q = np.load(os.path.join(d, f"rank{r}_codes.npy"))
        got_s = np.load(os.path.join(d, f"rank{r}_scales.npy"))
        assert got_q.dtype == np.int8 and got_q.shape == (2, 512)
        np.testing.assert_array_equal(got_q, np.asarray(q))
        np.testing.assert_array_equal(got_s.view(np.uint32), np.asarray(s).view(np.uint32))


def test_reduced_mean_and_residual_bit_for_bit(pod_run):
    """The mean over pods is the reference's ``jnp.sum(q_all * s_all, 0)``
    on the reference's codes, and each pod's residual its own corrected
    gradient less its dequantized codes: every rank, the same bits."""
    d, inputs, _ = pod_run
    want, residuals = _reference_ef(inputs, "g", "r", (1000,))
    for r in range(WORLD):
        got = np.load(os.path.join(d, f"rank{r}_reduced.npy"))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        got = np.load(os.path.join(d, f"rank{r}_residual.npy"))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      residuals[_pod_of(r)].view(np.uint32))


def _reference_ef(inputs, g, r, shape):
    """The reference's EF mean over the two pods of whole tensors:
    (reduced, each pod's residual)."""
    codes = []
    for p in range(2):
        corrected = jnp.asarray(inputs[f"{g}_pod{p}"]) + jnp.asarray(inputs[f"{r}_pod{p}"])
        codes.append((corrected, *jcompress._quantize_block(corrected)))
    q_all = jnp.stack([c[1] for c in codes])
    s_all = jnp.stack([c[2] for c in codes])
    summed = jnp.sum(q_all.astype(jnp.float32) * s_all, axis=0)
    size = int(np.prod(shape))
    reduced = np.asarray(summed.reshape(-1)[:size].reshape(shape) / 2)
    residuals = [np.asarray(c - jcompress._dequantize_block(q, s, shape, size))
                 for c, q, s in codes]
    return reduced, residuals


def test_only_int8_codes_and_f32_scales_cross_pod(pod_run):
    _, inputs, outs = pod_run
    sizes = [v.size for k, v in inputs.items() if k.startswith("params/")]
    for out in outs:
        assert out["traffic_4096"] == {"int8": 4096, "float32": 8 * 4}
        # three train steps: each rank's share of every parameter as codes,
        # at most numel / (data x model) = numel / 2 of it, and at most one
        # scale per block
        assert set(out["ef_traffic"]) == {"int8", "float32"}
        assert out["ef_traffic"]["int8"] <= 3 * sum(-(-n // 2) for n in sizes)
        assert out["ef_traffic"]["float32"] <= 3 * 4 * sum(-(-n // 512) for n in sizes)
    for p in range(2):  # the two ranks of a pod send each element once
        assert sum(outs[r]["ef_traffic"]["int8"] for r in range(WORLD)
                   if _pod_of(r) == p) == 3 * sum(sizes)


@pytest.mark.parametrize("layout", ["rows", "cols", "rep"])
def test_sharded_leaf_reduces_as_the_whole_tensor(pod_run, layout):
    """A DTensor leaf on the pod-free (data, model) = (1, 2) mesh, by rows,
    by columns (a block spans both ranks' columns) or replicated: the mean
    and each pod's residual equal the reference's on the whole tensors, bit
    for bit, the layout is kept, and each rank sends half the codes and
    only the scales of the blocks its half touches."""
    d, inputs, outs = pod_run
    reduced, residuals = _reference_ef(inputs, "g2", "r2", (24, 40))
    want_placements = {"rows": "(Replicate(), Shard(dim=0))",
                       "cols": "(Replicate(), Shard(dim=1))",
                       "rep": "(Replicate(), Replicate())"}[layout]
    for r, out in enumerate(outs):
        got = np.load(os.path.join(d, f"rank{r}_g2_{layout}_reduced.npy"))
        np.testing.assert_array_equal(got.view(np.uint32), reduced.view(np.uint32))
        got = np.load(os.path.join(d, f"rank{r}_g2_{layout}_residual.npy"))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      residuals[_pod_of(r)].view(np.uint32))
        assert out[f"g2_{layout}_placements"] == want_placements
        traffic = out[f"g2_{layout}_traffic"]
        assert traffic["int8"] == 24 * 40 // 2
        assert traffic["float32"] <= 4 * 2  # 960 elements: two blocks


def test_grad_compression_train_step(pod_run):
    _, _, outs = pod_run
    for out in outs:
        losses = out["ef_losses"]
        assert losses[-1] < losses[0], losses
        assert out["ef_residual_max"] > 0  # error feedback carries something
        assert out["ef_state_mesh"] == ["data", "model"]
        # each pod's half of the batch, averaged over 'pod': the full batch's loss
        assert abs(losses[0] - out["unsharded_first_loss"]) < SHARDED_LOSS_TOL
    assert all(o["ef_losses"] == outs[0]["ef_losses"] for o in outs)
    for path in outs[0]["ef_replicas"]:  # the pods hold one set of parameters
        seen: dict = {}
        for out in outs:
            rec = out["ef_replicas"][path]
            seen.setdefault(rec["key"], set()).add(rec["hash"])
        assert all(len(h) == 1 for h in seen.values()), (path, seen)


def _sequential(w, xs):
    y = xs
    for i in range(S):
        y = jnp.tanh(y @ w[i])
    return y


@pytest.mark.parametrize("variant", ["", "_sharded"])
def test_pipeline_matches_the_sequential_stack(pod_run, variant):
    d, inputs, _ = pod_run
    w, xs = jnp.asarray(inputs["pipe_w"]), jnp.asarray(inputs["pipe_x"])
    ref = np.asarray(_sequential(w, xs))
    gref = np.asarray(jax.grad(lambda w_: _sequential(w_, xs).sum())(w))
    for r in range(WORLD):
        out = np.load(os.path.join(d, f"rank{r}_pipe_out{variant}.npy"))
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)
        grad = np.load(os.path.join(d, f"rank{r}_pipe_grad{variant}.npy"))
        np.testing.assert_allclose(grad, gref, rtol=2e-4, atol=2e-5)


def test_bubble_fraction(pod_run):
    _, _, outs = pod_run
    assert all(abs(o["bubble_4_6"] - 3 / 9) < 1e-9 for o in outs)
    assert outs[0]["bubble_4_6"] == j_bubble_fraction(4, 6)


def test_elastic_restore_onto_another_mesh(pod_run):
    _, _, outs = pod_run
    for r, out in enumerate(outs):
        assert out["elastic_step"] == 1 and out["elastic_equal"]
        assert out["elastic_placements"] == "(Replicate(), Shard(dim=0))"
        model = r % 2  # (data, model) = (2, 2): the model coordinate
        assert out["elastic_local"] == list(np.arange(64.0)[32 * model: 32 * (model + 1)])


def test_each_package_reads_the_others_checkpoint(pod_run):
    d, _, outs = pod_run
    step, state = JCheckpointManager(os.path.join(d, "port_ckpt")).restore()
    assert step == 1
    np.testing.assert_array_equal(np.asarray(state["x"]), np.arange(64.0))
    assert int(state["opt"]["step"]) == 1
    for out in outs:
        assert out["ref_ckpt_step"] == 3
        assert out["ref_ckpt_x"] == list(np.arange(64.0) * 2)
        assert out["ref_ckpt_placements"] == "(Replicate(), Shard(dim=0))"
