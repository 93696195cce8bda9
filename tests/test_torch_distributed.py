"""Training over a mesh on the CPU: four gloo ranks (``torch_dist_ranks.py``,
which imports neither JAX nor the reference) run the port's train step on
a (2, 2) ('data', 'model') ``DeviceMesh`` with the reference's sharding
rules, and ``torchrun`` runs the port's launcher with ``--mesh 2,2``.

The reference's own bound for a sharded step against the single-device
step is ``SHARDED_LOSS_TOL`` (5e-4 in loss; ``tests/test_distributed.py``);
the observed gap is 0 to 4.8e-7 (the (B, S, V) means and logsumexps sum in
other orders over the shards).  Against the reference's jitted
single-device step, the port is held to ``LOSS_TOL`` (1e-5 relative, as in
``test_torch_train.py``).  Parameters are drawn with numpy and carried
across with ``convert.params_from_jax``; the reference's losses are
computed here and the ranks' records compared with them.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.policy import PRESETS as J_POLICIES
from repro.models import build_model as j_build_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep

from test_torch_common import flat_numpy, numpy_params, spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDED_LOSS_TOL = 5e-4
LOSS_TOL = 1e-5
#: a sharded gradient leaf against the unsharded one, over the leaf's scale
#: (GRAD_TOL_NATIVE of test_torch_train.py: f32 sums in other orders)
GRAD_TOL = 2.0**-14
WORLD = 4


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """The reference's two jitted steps here; the ranks' two unsharded and
    two sharded steps from the same numpy parameters and batch."""
    d = tmp_path_factory.mktemp("step_2x2")
    cfg = j_get_smoke_config("qwen1.5-0.5b").with_policy(J_POLICIES["native_f32"])
    model = j_build_model(cfg)
    params = numpy_params(model, 0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (8, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    np.savez(os.path.join(d, "inputs.npz"), **flat_numpy(params, "params"), **batch)
    tcfg = jstep.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-3, warmup_steps=0))
    step = jax.jit(jstep.make_train_step(model, tcfg))
    jparams = jax.tree.map(jnp.asarray, params)
    state = {"params": jparams, "opt": jadamw.init_state(jparams, tcfg.optimizer)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = []
    for _ in range(2):
        state, m = step(state, jbatch)
        ref.append(float(m["loss"]))
    return ref, spawn_ranks("step_2x2", WORLD, d)


def test_sharded_step_within_the_references_bound_of_the_unsharded_step(step_run):
    _, outs = step_run
    for out in outs:
        for sharded, plain in zip(out["sharded_losses"], out["unsharded_losses"], strict=True):
            assert abs(sharded - plain) < SHARDED_LOSS_TOL, out
        assert abs(out["sharded_grad_norm"] - out["unsharded_grad_norm"]) \
            <= 1e-5 * out["unsharded_grad_norm"]
        assert out["grad_gap"] <= GRAD_TOL


def test_sequence_parallel_step_within_the_bound_of_the_unsharded_step(step_run):
    """qwen1.5-4b's smoke config shards the sequence over 'model' (its
    attention runs on each rank's rows from their offset) and its
    parameters over 'data' too."""
    _, outs = step_run
    for out in outs:
        (loss, gnorm), (want, want_gnorm) = out["sp_sharded"], out["sp_unsharded"]
        assert abs(loss - want) < SHARDED_LOSS_TOL
        assert abs(gnorm - want_gnorm) <= 1e-5 * want_gnorm
        assert out["sp_grad_gap"] <= GRAD_TOL


def test_sharded_step_matches_the_references_single_device_step(step_run):
    ref, outs = step_run
    for out in outs:
        for got, want in zip(out["sharded_losses"], ref, strict=True):
            assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


def test_every_rank_reports_the_same_metrics(step_run):
    _, outs = step_run
    assert all(o["sharded_losses"] == outs[0]["sharded_losses"] for o in outs)
    assert all(o["metric_types"] == ["Tensor"] for o in outs)  # plain, not DTensor


def test_parameters_keep_their_placements_and_are_sharded(step_run):
    _, outs = step_run
    assert all(o["placements_kept"] for o in outs)
    assert all(o["sharded_leaves"] > 0 for o in outs)
    # AdamW's first steps move an element by up to ~lr whatever its gradient
    # (g / (|g| + eps)), so the bound is a share of the two steps' lr
    assert all(o["param_gap"] < 2 * 1e-3 for o in outs)


def test_replicas_are_bit_identical_across_ranks(step_run):
    """After two steps, every leaf of the state (parameters, moments, step)
    holds the same bytes on every rank that holds the same shard of it."""
    _, outs = step_run
    paths = outs[0]["replicas"].keys()
    assert len(paths) > 20
    groups = 0
    for path in paths:
        seen: dict = {}
        for out in outs:
            rec = out["replicas"][path]
            seen.setdefault(rec["key"], set()).add(rec["hash"])
        assert all(len(h) == 1 for h in seen.values()), (path, seen)
        groups += sum(1 for _ in seen)
    assert groups < len(paths) * WORLD  # some leaves really are replicated


def test_meshes_of_the_launcher(step_run):
    _, outs = step_run
    for out in outs:
        assert out["local_mesh"] == [["data", "model"], [WORLD, 1]]
        assert out["production_refused"] == "a (16, 16) mesh needs 256 ranks; this run has 4"


def _final_loss(text: str) -> tuple[float, float]:
    m = re.search(r"^loss (\S+) -> (\S+)$", text, re.M)
    assert m, text[-3000:]
    return float(m.group(1)), float(m.group(2))


def test_launcher_trains_over_a_2x2_mesh_under_torchrun():
    args = ["-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b", "--smoke",
            "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    single = subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                            timeout=300, cwd=ROOT)
    assert single.returncode == 0, single.stderr[-3000:]
    meshed = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--rdzv-backend=c10d",
         "--rdzv-endpoint=localhost:0", "--nnodes=1", f"--nproc-per-node={WORLD}",
         *args, "--mesh", "2,2"], env=env, capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert meshed.returncode == 0, meshed.stdout[-2000:] + meshed.stderr[-3000:]
    assert "mesh 2,2" in meshed.stdout and "A13" not in meshed.stdout + meshed.stderr
    assert meshed.stdout.count("loss ") == 1  # rank 0 prints
    first, last = _final_loss(meshed.stdout)
    want_first, want_last = _final_loss(single.stdout)
    assert abs(first - want_first) <= SHARDED_LOSS_TOL
    assert abs(last - want_last) <= SHARDED_LOSS_TOL

