"""The port's cost reader (``repro_torch.launch.op_cost``) against the
reference's HLO cost parser (``repro.launch.hlo_cost``): the counterparts of
``tests/test_hlo_cost.py``'s six tests (scans as Python loops, the
multi-device collective on a fake process group in a subprocess), a single
dot against ``parse_hlo_cost``, each hand-kernel wrapper charging its kernel
once on the CPU, the smoke qwen train step and an ``xla`` decode step's dot
FLOPs against the reference's compiled programs (within 1 %), and fake
tensors counting what real ones do."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch.hlo_cost import parse_hlo_cost

from repro_torch import oprecord
from repro_torch.launch import op_cost
from repro_torch.launch.op_cost import Cost, record_ops, roofline_terms
from repro_torch.plan.cost import F32_FLOPS, HBM_BW, NVLINK_BW, PEAK_FLOPS
from test_torch_common import make_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: dot FLOPs of a smoke step: port against the reference, relative
STEP_FLOPS_TOL = 0.01


def _flops(fn, *shapes):
    args = [torch.randn(s) for s in shapes]
    _, rec = record_ops(fn, *args)
    return rec.cost.flops


class TestParser:
    def test_single_dot_exact(self):
        assert _flops(lambda x, y: x @ y, (128, 256), (256, 64)) == 2 * 128 * 256 * 64

    def test_single_dot_equals_reference(self):
        a = jax.ShapeDtypeStruct((128, 256), jnp.float32)
        b = jax.ShapeDtypeStruct((256, 64), jnp.float32)
        ref = parse_hlo_cost(jax.jit(lambda x, y: x @ y).lower(a, b).compile().as_text())
        assert _flops(lambda x, y: x @ y, (128, 256), (256, 64)) == ref.flops

    def test_loop_counts_every_iteration(self):
        # the reference's scan of 5: an eager loop dispatches all five
        def loop5(x):
            for _ in range(5):
                x = x @ x
            return x

        assert _flops(loop5, (64, 64)) == 5 * 2 * 64**3

    def test_nested_loops_multiply(self):
        def nested(x):
            for _ in range(4):
                for _ in range(3):
                    x = x @ x
            return x

        assert _flops(nested, (32, 32)) == 12 * 2 * 32**3

    def test_checkpointed_grad_counts_recompute(self):
        from torch.utils.checkpoint import checkpoint

        def layer(c):
            return torch.tanh(c @ c)

        def grad(x):
            x = x.detach().requires_grad_(True)
            c = x
            for _ in range(4):
                c = checkpoint(layer, c, use_reentrant=False)
            (g,) = torch.autograd.grad(c.sum(), x)
            return g

        # fwd + recompute + 2 bwd matmuls per layer = 4 units
        assert _flops(grad, (32, 32)) >= 4 * 3 * 2 * 32**3

    def test_collective_bytes_multi_device(self):
        # a contraction over a sharded dim must all-reduce: 8 ranks of a fake
        # process group in a subprocess, on fake tensors
        code = textwrap.dedent("""
            import torch, torch.distributed as dist
            torch.set_num_threads(1)
            from torch._subclasses.fake_tensor import FakeTensorMode
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import DTensor, Replicate, Shard
            from torch.testing._internal.distributed.fake_pg import FakeStore
            from repro_torch.launch.op_cost import record_ops
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
            mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
            with FakeTensorMode():
                a = DTensor.from_local(torch.empty(64, 32), mesh, [Shard(1)], run_check=False,
                                       shape=(64, 256), stride=(256, 1))
                w = DTensor.from_local(torch.empty(32, 64), mesh, [Shard(0)], run_check=False,
                                       shape=(256, 64), stride=(64, 1))
                _, rec = record_ops(lambda x, y: (x @ y).redistribute(mesh, [Replicate()]), a, w)
            cost = rec.cost
            dist.destroy_process_group()
            assert cost.collective_bytes > 0, "contraction over sharded dim must psum"
            assert "all-reduce" in cost.by_collective, dict(cost.by_collective)
            assert cost.flops == 2 * 64 * 32 * 64, cost.flops  # one rank's share
            print("OK", cost.collective_bytes)
        """)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "OK" in out.stdout

    def test_roofline_terms_dominance(self):
        c = Cost(flops=PEAK_FLOPS, hbm_bytes=1.0, collective_bytes=1.0)
        c.flops_by_dtype[torch.bfloat16] = PEAK_FLOPS
        t = roofline_terms(c)
        assert t["dominant"] == "compute" and t["t_compute_s"] == pytest.approx(1.0)
        c = Cost(flops=F32_FLOPS, hbm_bytes=1.0, collective_bytes=1.0)
        c.flops_by_dtype[torch.float32] = F32_FLOPS  # f32 at the f32 rate (TF32 off)
        assert roofline_terms(c)["t_compute_s"] == pytest.approx(1.0)
        c = Cost(flops=1.0, hbm_bytes=HBM_BW * 2, collective_bytes=1.0)
        assert roofline_terms(c)["dominant"] == "memory"
        c = Cost(flops=1.0, hbm_bytes=1.0, collective_bytes=NVLINK_BW * 3)
        t = roofline_terms(c)
        assert t["dominant"] == "collective" and t["t_collective_s"] == pytest.approx(3.0)


class TestOpClasses:
    def test_views_are_free_and_copies_are_one_pass(self):
        x = torch.randn(64, 32)
        _, rec = record_ops(lambda t: t.t().reshape(32, 64).expand(2, 32, 64), x)
        assert rec.cost.hbm_bytes == 0 and rec.cost.flops == 0
        _, rec = record_ops(lambda t: t + 1, x)
        assert rec.cost.hbm_bytes == 2 * x.numel() * 4

    def test_gather_and_scatter(self):
        pool = torch.randn(64, 8)
        idx = torch.arange(16)
        _, rec = record_ops(lambda p, i: p[i], pool, idx)
        assert rec.cost.hbm_bytes == 2 * 16 * 8 * 4
        upd = torch.randn(16, 8)
        _, rec = record_ops(lambda p, i, u: p.index_put_((i,), u), pool.clone(), idx, upd)
        assert rec.cost.hbm_bytes == 2 * upd.numel() * 4


def _kernel_events(rec):
    return [e for e in rec.events if e.kind == "kernel"]


class TestKernelCharges:
    """Each wrapper charges its kernel once, with the GEMM terms
    ``chip_smoke.gemm_bound_ms`` reads; the plain version's ops are not
    recorded."""

    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_limb_matmul(self, k):
        from repro_torch.kernels.limb_matmul.ops import limb_matmul

        a, b = torch.randn(8, 96), torch.randn(96, 40)
        _, rec = record_ops(limb_matmul, a, b, k)
        (ev,) = _kernel_events(rec)
        flops, nbytes = oprecord.gemm_work(8, 96, 40, k * (k + 1) // 2)
        assert (ev.name, ev.flops, ev.nbytes) == ("limb_matmul", flops, nbytes)
        assert not any(e.name.startswith("aten.mm") or "bmm" in e.name for e in rec.events)
        assert rec.cost.flops == flops

    def test_limb_matmul_grte_charges_its_prepass(self):
        from repro_torch.kernels.limb_matmul.ops import limb_matmul

        a, b = torch.randn(8, 96), torch.randn(96, 40)
        _, rec = record_ops(lambda x, y: limb_matmul(x, y, 2, rounding="grte"), a, b)
        assert [e.name for e in _kernel_events(rec)] == [
            "quantize_mantissa", "quantize_mantissa", "limb_matmul"]

    def test_limb_matmul_dd(self):
        from repro_torch.kernels.limb_matmul.ops import limb_matmul_dd

        a, b = torch.randn(8, 40), torch.randn(40, 16)
        _, rec = record_ops(limb_matmul_dd, a, b, 4)
        (ev,) = _kernel_events(rec)
        assert (ev.name, ev.flops, ev.nbytes) == (
            ("limb_matmul_dd",) + oprecord.gemm_work(8, 40, 16, 10, outputs=2))
        assert rec.n_ops == 0

    def test_tile_matmul_runtime(self):
        from repro_torch.kernels.tile_matmul.ops import tile_matmul_runtime

        a, b = torch.randn(8, 96), torch.randn(96, 40)
        mode = torch.tensor(2, dtype=torch.int32)
        _, rec = record_ops(tile_matmul_runtime, a, b, mode, bm=32, bn=32, bk=32)
        (ev,) = _kernel_events(rec)
        assert ev.name == "tile_matmul"
        assert ev.flops == oprecord.gemm_work(8, 96, 40, 6)[0]  # kmax's passes

    def test_quantize_mantissa(self):
        from repro_torch.kernels.quantize_mantissa.ops import quantize_mantissa_op

        x = torch.randn(32, 16)
        _, rec = record_ops(quantize_mantissa_op, x, 8)
        (ev,) = _kernel_events(rec)
        assert (ev.name, ev.flops, ev.nbytes, rec.n_ops) == ("quantize_mantissa", 0.0,
                                                              8.0 * x.numel(), 0)

    def test_no_recorder_no_charge(self):
        from repro_torch.kernels.limb_matmul.ops import limb_matmul

        assert oprecord.ACTIVE is None
        limb_matmul(torch.randn(4, 8), torch.randn(8, 4), 2)
        assert oprecord.ACTIVE is None


# --------------------------------------------------------------------------
# smoke steps against the reference's compiled programs

def _train_inputs(tm, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tm.cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, tm.cfg.vocab, (2, 16)).astype(np.int32)
    return toks, labels


def _ref_train_flops(jm, jp, toks, labels):
    from repro.optim import adamw as jadamw
    from repro.train.step import TrainConfig as JTrainConfig
    from repro.train.step import make_train_step as jmake

    tcfg = JTrainConfig()
    state = {"params": jp, "opt": jadamw.init_state(jp, tcfg.optimizer)}
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    hlo = jax.jit(jmake(jm, tcfg)).lower(state, batch).compile().as_text()
    return parse_hlo_cost(hlo).flops


def _port_train(tm, tp, toks, labels):
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig, make_train_step

    tcfg = TrainConfig()
    state = {"params": tp, "opt": adamw.init_state(tp, tcfg.optimizer)}
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    return make_train_step(tm, tcfg), state, batch


def test_train_step_dot_flops_equal_reference():
    jm, jp, tm, tp = make_pair("native_f32")
    toks, labels = _train_inputs(tm)
    ref = _ref_train_flops(jm, jp, toks, labels)
    step, state, batch = _port_train(tm, tp, toks, labels)
    _, rec = record_ops(step, state, batch)
    got = op_cost.dot_flops(rec.events)
    assert abs(got - ref) <= STEP_FLOPS_TOL * ref, (got, ref)
    assert rec.cost.flops == got  # every FLOP of the step is a dot's


@pytest.mark.parametrize("policy", ["M24", "M8"])
def test_xla_decode_step_dot_flops_equal_reference(policy):
    jm, jp, tm, tp = make_pair(policy)
    assert tm.cfg.policy.impl == "xla"
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
    hlo = jax.jit(jm.decode_step).lower(jp, jnp.asarray(toks), jm.init_decode_state(2, 64)
                                        ).compile().as_text()
    ref = parse_hlo_cost(hlo).flops
    _, rec = record_ops(tm.decode_step, tp, torch.as_tensor(toks), tm.init_decode_state(2, 64))
    got = op_cost.dot_flops(rec.events)
    assert abs(got - ref) <= STEP_FLOPS_TOL * ref, (got, ref)


def test_fake_tensors_count_what_real_ones_do():
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import NATIVE_F32
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg = get_smoke_config("qwen1.5-0.5b").with_policy(NATIVE_F32)
    tcfg = TrainConfig()

    def counted():
        model = build_model(cfg, device="cpu")
        params = model.init(0)
        state = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
        batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
                 "labels": torch.ones((2, 16), dtype=torch.int32)}
        _, rec = record_ops(make_train_step(model, tcfg), state, batch)
        return rec.cost.flops, rec.cost.hbm_bytes, rec.n_events

    real = counted()
    with FakeTensorMode():
        fake = counted()
    assert real == fake and real[0] > 0
