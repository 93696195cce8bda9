"""The cases of ``tests/test_checkpoint.py`` on the port
(``repro_torch.checkpoint.manager``): save / restore round-trips of a real
train state, retention, resume, and restoring under a different RMPM mode
(the mode bits are not part of the checkpoint — precision is a property of
the execution, not of the saved numbers).  Every comparison is exact: a
checkpoint holds the bits it was given."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager, _flatten, _unflatten
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import NATIVE_F32, PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.models import build_model
from repro_torch.train.loop import resume_or_init
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

import test_torch_common  # noqa: F401  (one PyTorch thread per process)


def _tiny(policy=NATIVE_F32):
    cfg = get_smoke_config("qwen1.5-0.5b").with_policy(policy)
    cfg = dataclasses.replace(cfg, n_layers=1)
    return cfg, build_model(cfg, device="cpu")


def _batch(cfg, batch=2, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}


def _assert_trees_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class TestFlatten:
    def test_roundtrip_nested(self):
        t = {"a": {"b": np.arange(3)}, "c": (np.zeros(2), np.ones(1))}
        flat = _flatten(t)
        back = _unflatten(flat)
        assert set(flat) == {"a/b", "c/[0]", "c/[1]"}
        np.testing.assert_array_equal(back["a"]["b"], np.arange(3))
        assert isinstance(back["c"], tuple) and len(back["c"]) == 2


class TestSaveRestore:
    def test_train_state_roundtrip(self, tmp_path):
        cfg, model = _tiny()
        tcfg = TrainConfig()
        state = init_train_state(model, 0, tcfg)
        step_fn = make_train_step(model, tcfg)
        state, _ = step_fn(state, _batch(cfg))

        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(3, state)
        assert mgr.latest_step() == 3
        step, restored = mgr.restore(device="cpu")
        assert step == 3
        _assert_trees_equal(state, restored)
        # a restored state must be steppable (optimizer slots intact), and
        # step exactly as the state it was saved from
        restored, metrics = step_fn(restored, _batch(cfg, seed=1))
        state, want = step_fn(state, _batch(cfg, seed=1))
        assert np.isfinite(float(metrics["loss"]))
        assert float(metrics["loss"]) == float(want["loss"])
        _assert_trees_equal(state, restored)

    def test_async_save_waits_and_commits(self, tmp_path):
        cfg, model = _tiny()
        state = init_train_state(model, 0, TrainConfig())
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(1, state)
        assert isinstance(mgr._thread, threading.Thread)
        mgr.wait()
        assert not mgr._thread.is_alive()
        assert mgr.latest_step() == 1
        # atomic commit: no .tmp_ directories survive
        assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp_")]

    def test_save_snapshots_before_returning(self, tmp_path):
        """``save`` copies to host memory before it returns: a state the
        caller changes while the thread writes is saved as it was."""
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        x = torch.zeros(1 << 16)
        mgr.save(1, {"x": x})
        x.fill_(1.0)
        mgr.wait()
        _, restored = mgr.restore(device="cpu")
        assert float(restored["x"].abs().max()) == 0.0

    def test_keep_k_gc(self, tmp_path):
        cfg, model = _tiny()
        state = init_train_state(model, 0, TrainConfig())
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        for s in (1, 2, 3, 4):
            mgr.save(s, state)
        assert mgr.all_steps() == [3, 4]

    def test_restore_missing_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            mgr.restore(device="cpu")
        assert mgr.latest_step() is None

    def test_resume_or_init_prefers_checkpoint(self, tmp_path):
        cfg, model = _tiny()
        state = init_train_state(model, 0, TrainConfig())
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        start, out = resume_or_init(mgr, lambda: state, device="cpu")
        assert start == 0 and out is state
        mgr.save(7, state)
        start, out = resume_or_init(mgr, lambda: (_ for _ in ()).throw(
            AssertionError("init_fn must not run when a checkpoint exists")), device="cpu")
        assert start == 7
        _assert_trees_equal(out, state)


class TestRestoreAcrossModes:
    def test_restore_under_different_rmpm_mode(self, tmp_path):
        """Save under the fast M8 policy, restore into an M24 model: the
        parameters are mode-agnostic f32; only the step's arithmetic
        changes.  Checkpoints survive mode shifts."""
        cfg8, model8 = _tiny(PrecisionPolicy(default=Mode.M8))
        tcfg = TrainConfig()
        state = init_train_state(model8, 0, tcfg)
        step8 = make_train_step(model8, tcfg)
        state, _ = step8(state, _batch(cfg8))
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, state)

        cfg24, model24 = _tiny(PrecisionPolicy(default=Mode.M24))
        step, restored = mgr.restore(device="cpu")
        step24 = make_train_step(model24, tcfg)
        restored, metrics = step24(restored, _batch(cfg24, seed=2))
        assert np.isfinite(float(metrics["loss"]))
        # and the other direction: the M24-trained state steps under M8
        back, metrics8 = step8(restored, _batch(cfg8, seed=3))
        assert np.isfinite(float(metrics8["loss"]))
