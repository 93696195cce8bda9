"""The training substrates of the port against the reference: AdamW
(``optim.adamw``), the checkpoint manager, the data pipeline and the
straggler monitor.  Every case of ``tests/test_substrates.py``'s
``TestAdamW``, ``TestCheckpoint``, ``TestData`` and ``TestStragglerMonitor``
runs here on the port, and beside them the port against the reference on
the same numpy inputs.

Tolerances:
  * ``_quant``: the int8 codes and f32 scales bit for bit (both round half
    to even).
  * ``schedule_lr``: within 1 ulp at every step.
  * ``apply_updates`` from the same state and gradients, 10 steps: ``m``,
    ``v`` and ``lr`` bit for bit, the parameters within ``PARAM_ULPS`` (2)
    ulps of the largest of the old value, the new one and the step between
    them.  XLA's CPU ``sqrt`` is not correctly rounded (one ulp off IEEE in
    ~0.6 % of elements); PyTorch's is.  That ulp of the step's denominator
    reaches the step through its quotient and the learning-rate product, and
    the subtraction rounds once more (measured: 1 ulp with f32 moments, 2
    with int8 ones).  With clipping on, the grad norm is a sum whose order differs
    between the two packages (one ulp, ``GNORM_ULPS``); that ulp reaches the
    clipped gradient, so the clipped case holds the parameters to
    ``CLIPPED_ULPS`` (16; measured: up to 8).
  * the data pipeline: the same batches, element for element.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.pipeline import PackedReader as JPackedReader
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import PackedReader, Prefetcher, SyntheticLM
from repro_torch.optim import adamw
from repro_torch.train.loop import StragglerMonitor

import test_torch_common  # noqa: F401  (one PyTorch thread per process)

PARAM_ULPS = 2
GNORM_ULPS = 2
CLIPPED_ULPS = 16


def _ulps(got, want, scale) -> float:
    """|got - want| in units of the f32 spacing at ``scale``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got.astype(np.float64) - want)
                  / np.spacing(np.abs(np.asarray(scale, np.float32)))).max())


class TestAdamW:
    def _quad(self, quantize):
        cfg = adamw.AdamWConfig(
            lr=0.1, warmup_steps=0, total_steps=100, schedule="const",
            weight_decay=0.0, quantize_moments=quantize,
        )
        params = {"w": torch.tensor([2.0, -3.0, 1.5])}
        state = adamw.init_state(params, cfg)
        for _ in range(60):
            w = params["w"].detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(torch.sum(w**2), w)
            params, state, metrics = adamw.apply_updates(params, {"w": grad}, state, cfg)
        return params, metrics

    def test_converges(self):
        params, metrics = self._quad(False)
        assert float(params["w"].abs().max()) < 0.15
        assert float(metrics["lr"]) == pytest.approx(0.1)

    def test_quantized_moments_converge(self):
        params, _ = self._quad(True)
        assert float(params["w"].abs().max()) < 0.3

    def test_quantized_state_is_int8(self):
        cfg = adamw.AdamWConfig(quantize_moments=True)
        params = {"w": torch.zeros((4, 512))}
        st = adamw.init_state(params, cfg)
        q, scale = st["m"]["w"]
        assert q.dtype == torch.int8 and tuple(q.shape) == (4, 2, 256)
        assert tuple(scale.shape) == (4, 2, 1)
        assert st["m"]["w"][0] is not st["v"]["w"][0]  # distinct moments
        assert st["step"].dtype == torch.int32

    def test_schedule_warmup_cosine(self):
        cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
        assert float(adamw.schedule_lr(cfg, torch.tensor(5, dtype=torch.int32))) == \
            pytest.approx(0.5)
        assert float(adamw.schedule_lr(cfg, torch.tensor(10, dtype=torch.int32))) == \
            pytest.approx(1.0)
        assert float(adamw.schedule_lr(cfg, torch.tensor(110, dtype=torch.int32))) == \
            pytest.approx(0.0, abs=1e-6)

    def test_grad_clipping(self):
        cfg = adamw.AdamWConfig(grad_clip=1.0, warmup_steps=0, schedule="const")
        params = {"w": torch.zeros(3)}
        state = adamw.init_state(params, cfg)
        huge = {"w": torch.tensor([1e4, 1e4, 1e4])}
        _, _, m = adamw.apply_updates(params, huge, state, cfg)
        assert float(m["grad_norm"]) > 1e4  # reported pre-clip

    def test_arguments_unchanged(self):
        """The update returns new tensors and leaves its arguments as they
        were (a checkpoint or a second step may still read them)."""
        cfg = adamw.AdamWConfig(warmup_steps=0)
        params = {"w": torch.ones(4)}
        state = adamw.init_state(params, cfg)
        new_p, new_s, _ = adamw.apply_updates(params, {"w": torch.ones(4)}, state, cfg)
        assert torch.equal(params["w"], torch.ones(4)) and int(state["step"]) == 0
        assert float(state["m"]["w"].abs().sum()) == 0.0
        assert int(new_s["step"]) == 1 and not torch.equal(new_p["w"], params["w"])


class TestAdamWVsReference:
    def test_quant_bit_equal(self):
        rng = np.random.default_rng(0)
        for shape in ((4, 512), (3, 5, 256), (7, 10), (6,), ()):
            x = np.asarray(rng.standard_normal(shape) * 3, dtype=np.float32)
            x.flat[0] = 0.0  # a zero and a tie-prone scale
            qj, sj = jadamw._quant(jnp.asarray(x))
            qt, st = adamw._quant(torch.from_numpy(x))
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
            np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                          np.asarray(sj).view(np.uint32))
            back_j = np.asarray(jadamw._dequant(qj, sj, x.shape, x.size))
            np.testing.assert_array_equal(adamw._dequant(qt, st, x.shape).numpy(), back_j)

    @pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
    def test_schedule_lr_within_one_ulp(self, schedule):
        kw = dict(lr=3e-4, warmup_steps=7, total_steps=40, schedule=schedule)
        jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        for step in range(0, 45):
            want = float(jadamw.schedule_lr(jcfg, jnp.int32(step)))
            got = adamw.schedule_lr(tcfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert _ulps(got.numpy(), want, max(abs(want), 1e-30)) <= 1, step

    @pytest.mark.parametrize("quantize", [False, True])
    @pytest.mark.parametrize("clip", [0.0, 1.0])
    def test_apply_updates_ten_steps(self, quantize, clip):
        """Ten steps, each from the reference's state of the step before,
        through both packages' ``apply_updates`` on the same gradients."""
        kw = dict(lr=0.1, warmup_steps=3, total_steps=20, grad_clip=clip,
                  quantize_moments=quantize)
        jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        rng = np.random.default_rng(1)
        shapes = {"a": {"w": (8, 256)}, "b": (5,), "c": {"s": ()}}
        params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                              is_leaf=lambda x: isinstance(x, tuple))
        jp = jax.tree.map(jnp.asarray, params)
        js = jadamw.init_state(jp, jcfg)

        def to_torch(tree):
            return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)

        for _ in range(10):
            grads = jax.tree.map(lambda s: (rng.standard_normal(s) * 0.5).astype(np.float32),
                                 shapes, is_leaf=lambda x: isinstance(x, tuple))
            tp, ts = to_torch(jp), to_torch(js)
            jp2, js2, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, grads), js, jcfg)
            tp2, ts2, tm = adamw.apply_updates(tp, to_torch(grads), ts, tcfg)
            assert int(ts2["step"]) == int(js2["step"]) and ts2["step"].dtype == torch.int32
            assert float(tm["lr"]) == float(jm["lr"])
            assert _ulps(tm["grad_norm"].numpy(), jm["grad_norm"],
                         float(jm["grad_norm"])) <= GNORM_ULPS
            limit = PARAM_ULPS if not clip else CLIPPED_ULPS
            for old, want, got in zip(jax.tree.leaves(jp), jax.tree.leaves(jp2),
                                      jax.tree.leaves(tp2)):
                old, want = np.asarray(old), np.asarray(want)
                scale = np.maximum(np.maximum(np.abs(old), np.abs(want)), np.abs(old - want))
                assert _ulps(got.numpy(), want, scale) <= limit
            if not clip:
                for want, got in zip(jax.tree.leaves(js2["m"]) + jax.tree.leaves(js2["v"]),
                                     jax.tree.leaves(ts2["m"]) + jax.tree.leaves(ts2["v"])):
                    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            jp, js = jp2, js2

    def test_global_norm(self):
        rng = np.random.default_rng(2)
        tree = {"x": rng.standard_normal((300, 70)).astype(np.float32),
                "y": {"z": rng.standard_normal(11).astype(np.float32)}}
        want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))
        got = adamw.global_norm(jax.tree.map(torch.from_numpy, tree))
        assert _ulps(got.numpy(), want, want) <= GNORM_ULPS


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
                 "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
        mgr.save(3, state)
        step, restored = mgr.restore(device="cpu")
        assert step == 3
        np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                      np.arange(6.0).reshape(2, 3))
        assert int(restored["opt"]["step"]) == 7
        assert restored["opt"]["step"].dtype == torch.int32

    def test_keep_k_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        st = {"x": torch.zeros(1)}
        for s in (1, 2, 3, 4):
            mgr.save(s, st)
        assert mgr.all_steps() == [3, 4]

    def test_async_save_then_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
        mgr.save(1, {"x": torch.ones(8)})
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_atomicity_no_partial_dirs(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(5, {"x": torch.ones(2)})
        names = os.listdir(tmp_path)
        assert all(not n.startswith(".tmp") for n in names)

    def test_tuple_state_roundtrip(self, tmp_path):
        # quantized optimizer states contain tuples
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        st = {"m": {"w": (torch.ones((2, 4), dtype=torch.int8), torch.ones((2, 1)))}}
        mgr.save(1, st)
        _, r = mgr.restore(device="cpu")
        assert isinstance(r["m"]["w"], tuple) and r["m"]["w"][0].dtype == torch.int8

    def test_bfloat16_leaf_refused(self, tmp_path):
        """NumPy has no bfloat16: such a leaf fails loudly, nothing is written."""
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        with pytest.raises(TypeError, match="bfloat16"):
            mgr.save(1, {"p": {"w": torch.ones(2, dtype=torch.bfloat16)}})
        assert mgr.all_steps() == [] and os.listdir(tmp_path) == []

    def test_files_cross_packages(self, tmp_path):
        """The on-disk layout is the reference's: each package restores what
        the other saved."""
        w = np.arange(12, dtype=np.float32).reshape(3, 4)
        JCheckpointManager(str(tmp_path / "j"), async_save=False).save(
            2, {"p": {"w": jnp.asarray(w)}, "s": jnp.int32(9)})
        step, r = CheckpointManager(str(tmp_path / "j")).restore(device="cpu")
        assert step == 2 and int(r["s"]) == 9
        np.testing.assert_array_equal(r["p"]["w"].numpy(), w)
        CheckpointManager(str(tmp_path / "t"), async_save=False).save(
            4, {"p": {"w": torch.from_numpy(w)}, "s": torch.tensor(9, dtype=torch.int32)})
        step, r = JCheckpointManager(str(tmp_path / "t")).restore()
        assert step == 4 and int(r["s"]) == 9
        np.testing.assert_array_equal(np.asarray(r["p"]["w"]), w)
        with open(tmp_path / "t" / "step_00000004" / "manifest.json") as fh:
            assert '"process_count": 1' in fh.read()


class TestData:
    def test_synthetic_deterministic_and_learnable(self):
        d1 = SyntheticLM(vocab=64, seq_len=16, batch=4, seed=1)
        d2 = SyntheticLM(vocab=64, seq_len=16, batch=4, seed=1)
        b1, b2 = d1.next_batch(), d2.next_batch()
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        # labels shifted by one vs tokens
        np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])

    def test_skip_ahead_restart_consistency(self):
        d = SyntheticLM(vocab=64, seq_len=8, batch=2, seed=3)
        batches = [d.next_batch() for _ in range(5)]
        d2 = SyntheticLM(vocab=64, seq_len=8, batch=2, seed=3)
        d2.skip_to(3)
        np.testing.assert_array_equal(d2.next_batch()["tokens"], batches[3]["tokens"])

    def test_packed_reader_roundtrip(self, tmp_path):
        path = str(tmp_path / "tokens.bin")
        recs = np.arange(20 * 9, dtype=np.uint32).reshape(20, 9)
        PackedReader.write(path, recs)
        r = PackedReader(path, batch=4, rank=0, world=2, seed=0)
        b = r.next_batch()
        assert b["tokens"].shape == (4, 8) and b["labels"].shape == (4, 8)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_packed_reader_rank_disjoint(self, tmp_path):
        path = str(tmp_path / "t.bin")
        recs = np.arange(16 * 5, dtype=np.uint32).reshape(16, 5)
        PackedReader.write(path, recs)
        r0 = PackedReader(path, batch=4, rank=0, world=2, seed=0)
        r1 = PackedReader(path, batch=4, rank=1, world=2, seed=0)
        t0 = r0.next_batch()["tokens"][:, 0]
        t1 = r1.next_batch()["tokens"][:, 0]
        assert set(t0.tolist()).isdisjoint(t1.tolist())

    def test_prefetcher(self):
        d = SyntheticLM(vocab=16, seq_len=4, batch=2, seed=0)
        ref = SyntheticLM(vocab=16, seq_len=4, batch=2, seed=0)
        pf = Prefetcher(d, depth=2)
        try:
            for _ in range(3):
                np.testing.assert_array_equal(next(pf)["tokens"], ref.next_batch()["tokens"])
        finally:
            pf.close()


class TestDataVsReference:
    @pytest.mark.parametrize("seed", [0, 5])
    def test_synthetic_batches_equal(self, seed):
        ours = SyntheticLM(vocab=151936, seq_len=24, batch=3, seed=seed)
        theirs = JSyntheticLM(vocab=151936, seq_len=24, batch=3, seed=seed)
        theirs.skip_to(4)
        ours.skip_to(4)
        for _ in range(3):
            a, b = ours.next_batch(), theirs.next_batch()
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])

    def test_packed_reader_batches_equal(self, tmp_path):
        path = str(tmp_path / "shard.bin")
        recs = np.random.default_rng(3).integers(0, 2**31, (37, 11)).astype(np.uint32)
        PackedReader.write(path, recs)
        with open(path, "rb") as fh:
            ours_bytes = fh.read()
        JPackedReader.write(str(tmp_path / "ref.bin"), recs)
        with open(tmp_path / "ref.bin", "rb") as fh:
            assert fh.read() == ours_bytes
        for rank in (0, 1):
            ours = PackedReader(path, batch=4, rank=rank, world=2, seed=7)
            theirs = JPackedReader(path, batch=4, rank=rank, world=2, seed=7)
            for _ in range(6):  # past an epoch: the shuffle of the next one
                a, b = ours.next_batch(), theirs.next_batch()
                np.testing.assert_array_equal(a["tokens"], b["tokens"])
                np.testing.assert_array_equal(a["labels"], b["labels"])


class TestStragglerMonitor:
    def test_flags_outlier(self):
        mon = StragglerMonitor(alpha=0.3, z_threshold=3.0)
        for i in range(20):
            mon.observe(i, 0.1 + 0.001 * (i % 3))
        assert not mon.flagged
        assert mon.observe(99, 1.5)  # 15x step time -> straggler
        assert mon.flagged and mon.flagged[-1][0] == 99

    def test_same_flags_as_reference(self):
        from repro.train.loop import StragglerMonitor as JStragglerMonitor

        rng = np.random.default_rng(4)
        dts = 0.1 + 0.002 * rng.standard_normal(60)
        dts[[20, 41]] = 0.9
        ours, theirs = StragglerMonitor(), JStragglerMonitor()
        for i, dt in enumerate(dts):
            assert ours.observe(i, float(dt)) == theirs.observe(i, float(dt))
        assert ours.flagged == theirs.flagged and len(ours.flagged) == 2
