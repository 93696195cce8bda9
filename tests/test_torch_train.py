"""The port's training slice against the reference (``repro.train``,
``repro.optim``, ``repro.adapt``'s training half) on the same numpy-made
parameters and batches, on the CPU.

Gradients: the oracle is ``jax.grad`` of the reference's ``make_loss_fn``
(the reference defines no custom VJP: its gradients are JAX's derivatives
of the limb algebra through ``split_limbs``' casts).  ``convert`` is a pure
re-layout, so the reference's gradient tree maps leaf for leaf onto the
port's.  Each leaf is held by its largest deviation over its largest
magnitude:
  * ``NATIVE_F32``: ``GRAD_TOL_NATIVE`` (2^-14).  One f32 product per site;
    the two frameworks sum in other orders, and backpropagation through a
    few layers carries those last-bit differences (measured: up to 2e-5).
  * ``M16``, ``impl='xla'``: the limb cotangents are rounded to bf16 at the
    same casts in both packages — each product's cotangent at its own cast
    of a bf16 limb, a limb's cotangents summed in bf16, the residual's
    through its cast (``core.limb.limb_operands``).  Forward values that the
    two frameworks compute an f32 ulp apart can still round to neighbouring
    bf16 codes, and such a flip moves that cotangent by 2^-8 of itself.  So
    the leaves behind the logits site alone (``final_norm``, ``unembed``)
    agree to ``GRAD_TOL_LIMB_TOP`` (2^-9; measured 1e-3) and the leaves
    behind a layer to ``GRAD_TOL_LIMB`` (2^-5; measured 1.1e-2).  That is
    the method's own floor: the reference's jitted and eager gradients
    differ by up to 0.95e-2 of scale on this case.
  * The MoE family is held at ``NATIVE_F32`` only: the reference's expert
    product does not run at a limb mode on jax 0.9.0's CPU backend (ROADMAP
    Queue C).  Its layer rounds the expert inputs and outputs to bf16 at any
    policy; the reference does it in bf16 dispatch and combine products,
    whose transposes round each product's cotangent, the port in a gather
    and a scatter whose casts round the summed cotangent once.  So the
    family is held to ``GRAD_TOL_MOE`` (2^-7; measured up to 3.9e-3).

Losses: the 20-step curve from the same init and batches agrees step for
step to ``LOSS_TOL`` (1e-5, relative) at ``NATIVE_F32`` and to
``LOSS_TOL_LIMB`` (2^-10) at ``M16``, where the gradients' bf16 floor above
moves every update a little (measured: up to 9.3e-5 over 20 steps).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.adapt import SLO as JSLO
from repro.adapt import ModeTable as JModeTable
from repro.adapt import TrainPrecisionSchedule as JSchedule
from repro.configs import ARCH_IDS
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.core.precision import Mode as JMode
from repro.optim import adamw as jadamw
from repro.train import step as jstep

from repro_torch import tree
from repro_torch.adapt import SLO, ModeTable, TrainPrecisionSchedule
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import build
from repro_torch.kernels.limb_matmul.ops import limb_matmul, limb_matmul_dd
from repro_torch.kernels.quantize_mantissa.ops import quantize_mantissa_op
from repro_torch.kernels.tile_matmul.ops import (
    tile_matmul,
    tile_matmul_auto,
    tile_matmul_mode,
    tile_matmul_runtime,
)
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.train.loop import LoopConfig, train_loop

from test_torch_common import POLICY_CASES, make_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRAD_TOL_NATIVE = 2.0**-14
GRAD_TOL_LIMB_TOP = 2.0**-9
GRAD_TOL_LIMB = 2.0**-5
GRAD_TOL_MOE = 2.0**-7
LOSS_TOL = 1e-5
LOSS_TOL_LIMB = 2.0**-10
#: leaves whose gradient passes through the logits site and no layer
TOP_LEAVES = ("['final_norm']", "['unembed']['w']")

CASES = dict(POLICY_CASES)
CASES["M16"] = (PrecisionPolicy(default=Mode.M16), JPolicy(default=JMode.M16), Mode.M16)


def _batch(cfg, rng, b=2, s=16):
    """Numpy batch: tokens, labels, and the enc-dec / VLM extra input."""
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal((b, 16, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        batch["pixel_embeds"] = (rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model))
                                 * 0.02).astype(np.float32)
    return batch


def _as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _as_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _pair(policy, arch="qwen1.5-0.5b", **over):
    if policy not in POLICY_CASES:
        POLICY_CASES[policy] = CASES[policy]
    return make_pair(policy, arch=arch, **over)


def _grad_gaps(jgrads, tgrads) -> dict[str, float]:
    out = {}
    jl = jax.tree_util.tree_leaves_with_path(jgrads)
    tl = tree.leaves(tgrads)
    assert len(jl) == len(tl)
    for (path, want), got in zip(jl, tl):
        want = np.asarray(want, np.float64)
        assert tuple(got.shape) == want.shape
        if want.size:
            scale = max(np.abs(want).max(), 1e-30)
            out[jax.tree_util.keystr(path)] = float(np.abs(got.numpy() - want).max() / scale)
    return out


def _reference_grads(jmodel, jparams, batch):
    loss_fn = jstep.make_loss_fn(jmodel, jstep.TrainConfig())
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, _as_jax(batch))
    return metrics, grads


def _port_grads(tmodel, tparams, batch):
    grad_fn = tstep.value_and_grad(tstep.make_loss_fn(tmodel, tstep.TrainConfig()))
    return grad_fn(tparams, _as_torch(batch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_vs_jax_grad_native(arch):
    jmodel, jparams, tmodel, tparams = _pair("native_f32", arch=arch)
    batch = _batch(tmodel.cfg, np.random.default_rng(0))
    jm, jg = _reference_grads(jmodel, jparams, batch)
    tm, tg = _port_grads(tmodel, tparams, batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL * float(jm["loss"])
    gaps = _grad_gaps(jg, tg)
    tol = GRAD_TOL_MOE if tmodel.cfg.family == "moe" else GRAD_TOL_NATIVE
    assert max(gaps.values()) <= tol, gaps
    assert all(bool(torch.isfinite(g).all()) for g in tree.leaves(tg))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b", "recurrentgemma-9b"])
def test_grads_vs_jax_grad_m16(arch):
    """M16 through the plain limb algebra: gradients through the limb
    split's casts in both packages (see the module docstring)."""
    jmodel, jparams, tmodel, tparams = _pair("M16", arch=arch, n_layers=2)
    batch = _batch(tmodel.cfg, np.random.default_rng(0))
    jm, jg = _reference_grads(jmodel, jparams, batch)
    tm, tg = _port_grads(tmodel, tparams, batch)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_TOL)
    gaps = _grad_gaps(jg, tg)
    top = {k: v for k, v in gaps.items() if k in TOP_LEAVES}
    assert top and max(top.values()) <= GRAD_TOL_LIMB_TOP, top
    assert max(gaps.values()) <= GRAD_TOL_LIMB, gaps


def _reference_state(jparams, opt_cfg):
    return {"params": jparams, "opt": jadamw.init_state(jparams, opt_cfg)}


def _port_state(tparams, opt_cfg):
    return {"params": tparams, "opt": adamw.init_state(tparams, opt_cfg)}


@pytest.mark.parametrize("policy", ["native_f32", "M16"])
def test_loss_curve_20_steps_tracks_reference(policy):
    """20 steps of both train steps from the same parameters over the same
    SyntheticLM batch stream: the losses agree step for step."""
    kw = dict(lr=1e-3, warmup_steps=4, total_steps=20)
    jmodel, jparams, tmodel, tparams = _pair(policy, n_layers=2)
    jtrain = jax.jit(jstep.make_train_step(
        jmodel, jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**kw))))
    ttrain = tstep.make_train_step(tmodel, tstep.TrainConfig(optimizer=adamw.AdamWConfig(**kw)))
    js = _reference_state(jparams, jadamw.AdamWConfig(**kw))
    ts = _port_state(tparams, adamw.AdamWConfig(**kw))
    data = SyntheticLM(vocab=tmodel.cfg.vocab, seq_len=16, batch=2, seed=0)
    jl, tl = [], []
    for _ in range(20):
        batch = data.next_batch()
        js, jm = jtrain(js, _as_jax(batch))
        ts, tm = ttrain(ts, _as_torch(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=2.0**-23)  # 1 ulp
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL if policy == "native_f32" else LOSS_TOL_LIMB)


def test_accum_steps_2():
    """accum_steps=2 sums the two half-batches' gradients and halves them:
    the same gradients as one pass over the batch (up to f32 summation
    order), and the same step as the reference's scan; the metrics are the
    last microbatch's, as the reference's scan carries them."""
    jmodel, jparams, tmodel, tparams = _pair("native_f32", n_layers=2)
    batch = _batch(tmodel.cfg, np.random.default_rng(5), b=4)
    one = tstep.make_grad_fn(tmodel, tstep.TrainConfig())
    two = tstep.make_grad_fn(tmodel, tstep.TrainConfig(accum_steps=2))
    g1, _ = one(tparams, _as_torch(batch))
    g2, m2 = two(tparams, _as_torch(batch))
    for a, b in zip(tree.leaves(g1), tree.leaves(g2)):
        assert float((a - b).abs().max()) <= GRAD_TOL_NATIVE * float(a.abs().max())
    half = {k: v[2:] for k, v in batch.items()}
    _, m_last = one(tparams, _as_torch(half))
    assert float(m2["loss"]) == float(m_last["loss"])

    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jcfg = jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**kw), accum_steps=2)
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(**kw), accum_steps=2)
    js, jm = jax.jit(jstep.make_train_step(jmodel, jcfg))(
        _reference_state(jparams, jcfg.optimizer), _as_jax(batch))
    ts, tm = tstep.make_train_step(tmodel, tcfg)(
        _port_state(tparams, tcfg.optimizer), _as_torch(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_TOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=LOSS_TOL)
    for a, b in zip(jax.tree.leaves(js["params"]), tree.leaves(ts["params"])):
        # one AdamW step moves an element by at most ~lr: both steps agree
        # to a small share of it
        assert float(np.abs(b.numpy() - np.asarray(a)).max()) <= 0.05 * kw["lr"]


def _modal_schedule(table_cls, schedule_cls, slo_cls, policy):
    table = table_cls.from_policy(policy)
    return schedule_cls(table, slo_cls(max_err=0.5))


def test_schedule_same_shifts_as_reference():
    """Both packages' TrainPrecisionSchedule fed the same grad norms make
    the same decisions, event for event, and walk the same mode tables."""
    ours = _modal_schedule(ModeTable, TrainPrecisionSchedule, SLO,
                           PrecisionPolicy(default=Mode.M24))
    theirs = _modal_schedule(JModeTable, JSchedule, JSLO, JPolicy(default=JMode.M24))
    rng = np.random.default_rng(0)
    norms = 1.0 + 0.02 * rng.standard_normal(40)
    norms[[14, 15, 27]] = (3.0, 0.2, 5.0)  # drift spikes
    for step, gn in enumerate(norms, start=1):
        rec = {"grad_norm": float(gn)}
        assert ours.observe(step, rec, 0.1) == theirs.observe(step, rec, 0.1)
        assert ours.table.label() == theirs.table.label()
        assert ours.mode_scalars() == {k: int(v) for k, v in theirs.mode_scalars().items()}
    assert ours.table.switches == theirs.table.switches >= 3
    assert [d.decision for d in ours.controller.history] == \
        [d.decision for d in theirs.controller.history]


def test_modal_step_equals_static_step_at_each_mode():
    """The modal step (device-scalar modes, the ladder's products selected
    on the device) takes the static step of the mode it is given: the same
    loss bit for bit (the same products summed in the same order) and the
    same new parameters up to the order of the bf16 cotangent sums."""
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    ocfg = adamw.AdamWConfig(**kw)
    _, _, tmodel, tparams = _pair("M24", n_layers=1)
    batch = _as_torch(_batch(tmodel.cfg, np.random.default_rng(7)))
    table = ModeTable.from_policy(tmodel.cfg.policy)
    modal = tstep.make_modal_step(
        tstep.make_train_step(tmodel, tstep.TrainConfig(optimizer=ocfg)))
    for mode in (Mode.M8, Mode.M16, Mode.M24):
        for site in table.modes():
            table.set(site, mode)
        static_model = tmodel.with_policy(PrecisionPolicy(default=mode))
        static = tstep.make_train_step(static_model, tstep.TrainConfig(optimizer=ocfg))
        s_state, s_m = static(_port_state(tparams, ocfg), batch)
        m_state, m_m = modal(_port_state(tparams, ocfg), batch, table.scalars())
        assert float(m_m["loss"]) == float(s_m["loss"]), mode
        assert float(m_m["grad_norm"]) == pytest.approx(float(s_m["grad_norm"]), rel=1e-5)
        for a, b in zip(tree.leaves(s_state["params"]), tree.leaves(m_state["params"])):
            assert float((a - b).abs().max()) <= 0.05 * kw["lr"]


def test_modal_loop_shifts_modes_and_builds_nothing():
    """train_loop with a TrainPrecisionSchedule: the modal step runs at the
    modes the schedule picks, shifts them between steps (SLO wide enough to
    relax), builds no kernel and launches none."""
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=12)
    _, _, tmodel, tparams = _pair("M24", n_layers=1)
    schedule = TrainPrecisionSchedule(ModeTable.from_policy(tmodel.cfg.policy),
                                      SLO(max_err=10.0))
    step = tstep.make_modal_step(tstep.make_train_step(
        tmodel, tstep.TrainConfig(optimizer=adamw.AdamWConfig(**kw))))
    rng = np.random.default_rng(1)
    builds = build.BUILD_COUNT
    build.reset_launch_counts()
    _, hist = train_loop(step, _port_state(tparams, adamw.AdamWConfig(**kw)),
                         iter([_as_torch(_batch(tmodel.cfg, rng)) for _ in range(12)]),
                         LoopConfig(total_steps=12), adapt=schedule)
    # a record's mode is the table after that step's decision: step 1 ran
    # at M24 and shifted down at once (the probe's warmup reports no drift)
    assert [h["mode_shift"] for h in hist[:2]] == [-1, 0]
    assert hist[0]["mode"] == "M16" and hist[-1]["mode"] == "M8"
    assert schedule.table.switches == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert build.BUILD_COUNT == builds and sum(build.launch_counts().values()) == 0


def _operands(requires_grad):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    return a.requires_grad_(requires_grad), b


WRAPPERS = {
    "limb_matmul": lambda a, b: limb_matmul(a, b, 2),
    "limb_matmul_grte": lambda a, b: limb_matmul(a, b, 2, rounding="grte"),
    "limb_matmul_dd": lambda a, b: limb_matmul_dd(a, b, 4),
    "tile_matmul": lambda a, b: tile_matmul(a, b, torch.full((1, 1), 2, dtype=torch.int32)),
    "tile_matmul_mode": lambda a, b: tile_matmul_mode(a, b, Mode.M16),
    "tile_matmul_runtime": lambda a, b: tile_matmul_runtime(a, b, 2),
    "tile_matmul_auto": lambda a, b: tile_matmul_auto(a, b, 2.0**-8),
    "quantize_mantissa": lambda a, b: quantize_mantissa_op(a, 10),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrapper_under_grad_raises(name):
    """A kernel has no backward pass: with grad enabled and an operand that
    requires grad its wrapper raises (the plain version here, the kernel on
    the card), naming the reference's behaviour; without either it runs."""
    fn = WRAPPERS[name]
    a, b = _operands(True)
    with pytest.raises(NotImplementedError, match="impl='xla' or impl='native'"):
        fn(a, b)
    with pytest.raises(NotImplementedError, match="pallas_call"):
        fn(a, b.requires_grad_(True))
    with torch.no_grad():
        out = fn(a, b)
    assert out is not None
    a, b = _operands(False)
    fn(a, b)  # grad enabled, nothing requires grad: runs


@pytest.mark.parametrize("impl", ["pallas", "tile"])
def test_train_step_on_a_kernel_policy_raises(impl):
    """A policy that sends the sites to the hand-written kernels reaches the
    refusal and raises, as the reference's jax.grad through a Pallas kernel
    does; serving the same model under no_grad is unaffected."""
    _, _, tmodel, tparams = _pair("native_f32", n_layers=1)
    model = tmodel.with_policy(PrecisionPolicy(default=Mode.M16, impl=impl))
    batch = _as_torch(_batch(model.cfg, np.random.default_rng(0)))
    train = tstep.make_train_step(model, tstep.TrainConfig())
    with pytest.raises(NotImplementedError, match="no backward pass"):
        train(_port_state(tparams, adamw.AdamWConfig()), batch)
    logits, _ = model.apply(tparams, batch)
    assert logits.grad_fn is None and bool(torch.isfinite(logits).all())


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)


def test_launcher_smoke_cpu():
    out = _launch("--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "3")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "device cpu" in out.stdout
    last = [ln for ln in out.stdout.splitlines() if ln.startswith("loss ")]
    assert len(last) == 1 and " -> " in last[0]


def test_launcher_adapt_prints_schedule(tmp_path):
    out = _launch("--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "12",
                  "--batch", "2", "--seq", "16", "--policy", "paper_baseline", "--adapt",
                  "--slo-err", "0.5", "--ckpt-dir", str(tmp_path), "--checkpoint-every", "6")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "adaptive precision schedule: start" in out.stdout
    assert "precision schedule: M16 -> M8 (2 switches)" in out.stdout
    assert any(ln.startswith("step ") and " mode " in ln for ln in out.stdout.splitlines())
    assert sorted(os.listdir(tmp_path)) == ["step_00000006", "step_00000012"]
    again = _launch("--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "14",
                    "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path))
    assert again.returncode == 0 and "resumed at step 12" in again.stdout


@pytest.mark.parametrize("args, says", [
    pytest.param(("--arch", "qwen1.5-0.5b", "--mesh", "4,2"),
                 "a (4, 2) mesh needs 8 ranks; this run has 1", id="args0-A13"),
    (("--arch", "whisper-medium"), "multimodal"),
    (("--arch", "qwen1.5-0.5b", "--policy", "mixed", "--accuracy", "0.03"), None),
])
def test_launcher_refusals(args, says):
    """``--mesh`` in a run of fewer ranks than the mesh has (ROADMAP A13's
    launcher) refuses; enc-dec exits as the reference's does;
    a planned policy runs (on the CPU the planner keeps the limb algebra)."""
    out = _launch(*args, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                  "--seq", "8")
    if says is None:
        assert out.returncode == 0, out.stderr[-2000:]
        assert "planned policy" in out.stdout
    else:
        assert out.returncode != 0 and says in out.stderr
