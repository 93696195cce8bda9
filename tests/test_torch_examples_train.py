"""The training arms of ``examples/`` (``examples/train_lm_torch.py``,
``examples/autoprecision_train_torch.py``) on the CPU, from the reference's
parameters (numpy draws converted with ``convert.params_from_jax``), held
against the reference's own train step (``repro.train.step``) over the same
``SyntheticLM`` stream.

Cuts, made through the arms' arguments only (shapes, data, optimizer and
schedule are the reference scripts'):
  * ``train_lm``: ``--steps 20`` (the reference's default is 300), so the
    learning-rate schedule spans 20 steps; the preempted run stops at step
    ``CUT`` (``--stop-at``) and its resume runs one step (``--stop-at CUT+1``);
  * ``autoprecision_train``: ``--steps 4`` per policy (``STEPS`` is 60).

Tolerances are ``test_torch_train``'s: the losses agree step for step to
``LOSS_TOL`` (1e-5, relative) at native f32 and to ``LOSS_TOL_LIMB`` (2^-10)
at the limb policies.  A resumed run's next loss equals the uninterrupted
run's bit for bit (the checkpoint holds the state exactly).
"""
import dataclasses
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.core.policy import PRESETS as J_POLICIES
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.core.precision import Mode as JMode
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import build_model as j_build_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep

from repro_torch.convert import params_from_jax
from repro_torch.kernels import build

from test_torch_common import load_example, numpy_params
from test_torch_train import LOSS_TOL, LOSS_TOL_LIMB

TRAIN_STEPS = 20
CUT = 3
AUTO_STEPS = 4
#: the reference's policies, by the arm's names
J_AUTO_POLICIES = {
    "paper_baseline_M24(6 passes)": JPolicy(default=JMode.M24),
    "fast_M8(1 pass)": JPolicy(default=JMode.M8),
    "mixed(M8 bulk,M16 attn/logits)": JPolicy(
        default=JMode.M8, overrides=(("attn_qk", JMode.M16), ("logits", JMode.M16))),
}


def _reference_losses(mod, policy, opt_cfg, seq, batch, steps):
    """(numpy parameter draws, the reference's losses over ``steps`` steps
    of its own jitted train step from them)."""
    cfg = dataclasses.replace(j_get_config("qwen1.5-0.5b"), **mod.SHAPE).with_policy(policy)
    jmodel = j_build_model(cfg)
    tree = numpy_params(jmodel, 0)
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt": jadamw.init_state(params, opt_cfg)}
    step = jax.jit(jstep.make_train_step(jmodel, jstep.TrainConfig(optimizer=opt_cfg)))
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
    losses = []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in data.next_batch().items()})
        losses.append(float(m["loss"]))
    return tree, losses


@pytest.fixture(scope="module")
def train_lm(tmp_path_factory):
    """The uninterrupted run from converted parameters and the reference's
    first ``CUT + 1`` losses from the same draws."""
    mod = load_example("train_lm")
    opt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=TRAIN_STEPS)
    tree, ref = _reference_losses(mod, J_POLICIES["native_f32"], opt, mod.SEQ, mod.BATCH,
                                  CUT + 1)
    d = tmp_path_factory.mktemp("train_lm")
    out = mod.main(["--device", "cpu", "--steps", str(TRAIN_STEPS), "--fresh",
                    "--ckpt-dir", str(d / "full")], params=params_from_jax(tree, device="cpu"))
    return mod, tree, ref, out, d


def test_train_lm_losses_track_reference(train_lm):
    _, _, ref, out, _ = train_lm
    assert out["steps"] == list(range(1, TRAIN_STEPS + 1))
    np.testing.assert_allclose(out["losses"][:len(ref)], ref, rtol=LOSS_TOL)
    assert build.BUILD_COUNT == 0


def test_train_lm_loss_falls_and_checkpoints(train_lm):
    mod, tree, _, out, _ = train_lm
    assert out["judged"] and out["improved"] and out["last"] < out["first"]
    assert out["first"] == pytest.approx(np.mean(out["losses"][:mod.WINDOW]))
    assert out["checkpoints"] == [TRAIN_STEPS]  # the end of the run (every 100 otherwise)
    assert out["n_params"] == sum(x.size for x in jax.tree.leaves(tree))  # the reference's


def test_train_lm_resume_gives_the_uninterrupted_next_loss(train_lm, capsys):
    mod, tree, _, full, d = train_lm
    ckpt = str(d / "cut")
    base = ["--device", "cpu", "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt]
    cut = mod.main(base + ["--fresh", "--stop-at", str(CUT)],
                   params=params_from_jax(tree, device="cpu"))
    assert cut["steps"] == list(range(1, CUT + 1)) and cut["checkpoints"] == [CUT]
    assert not cut["judged"]
    assert cut["losses"] == full["losses"][:CUT]
    resumed = mod.main(base + ["--resume", "--stop-at", str(CUT + 1)])
    assert resumed["start"] == CUT and resumed["steps"] == [CUT + 1]
    assert resumed["losses"][0] == full["losses"][CUT]  # bit for bit
    assert f"resumed from step {CUT}" in capsys.readouterr().out


def test_autoprecision_losses_track_reference_per_policy():
    mod = load_example("autoprecision_train")
    assert set(mod.POLICIES) == set(J_AUTO_POLICIES)
    opt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=AUTO_STEPS)
    refs, tree = {}, None
    for name, policy in J_AUTO_POLICIES.items():
        tree, refs[name] = _reference_losses(mod, policy, opt, mod.SEQ, mod.BATCH, AUTO_STEPS)
    out = mod.main(["--device", "cpu", "--steps", str(AUTO_STEPS)],
                   params=params_from_jax(tree, device="cpu"))
    for name, ref in refs.items():
        np.testing.assert_allclose(out["curves"][name], ref, rtol=LOSS_TOL_LIMB, err_msg=name)
        assert all(math.isfinite(x) for x in out["curves"][name])
    base = np.mean(out["curves"][mod.BASELINE][-mod.TAIL:])
    for name, curve in out["curves"].items():
        assert out["gaps"][name] == pytest.approx(np.mean(curve[-mod.TAIL:]) - base)
    assert out["gaps"][mod.BASELINE] == 0.0
