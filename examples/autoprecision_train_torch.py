"""Beyond-paper demo on the PyTorch/CUDA port: per-layer precision policies
during training.

Trains the same tiny LM under three RMPM policies and compares loss curves —
the paper's power/accuracy dial, realized as a training-quality/cost dial.

    PYTHONPATH=src python examples/autoprecision_train_torch.py                # the GPU
    PYTHONPATH=src python examples/autoprecision_train_torch.py --device cpu

The port's counterpart of ``examples/autoprecision_train.py``: the same
policies, shapes, data and steps.  Gradients flow through the plain limb
algebra at each policy's modes (the hand-written kernels have no backward
pass, as the reference's Pallas kernels have none).  Without ``--device`` it
runs on the GPU and raises when there is none.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Mode
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step

POLICIES = {
    "paper_baseline_M24(6 passes)": PrecisionPolicy(default=Mode.M24),
    "fast_M8(1 pass)": PrecisionPolicy(default=Mode.M8),
    "mixed(M8 bulk,M16 attn/logits)": PrecisionPolicy(
        default=Mode.M8, overrides=(("attn_qk", Mode.M16), ("logits", Mode.M16))
    ),
}
BASELINE = "paper_baseline_M24(6 passes)"
STEPS = 60
#: the reference's reduced qwen1.5-0.5b shapes
SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
             remat=False, attn_chunk=64)
SEQ, BATCH = 64, 8
#: the final loss is the mean of the last TAIL steps
TAIL = 5


def run(policy: PrecisionPolicy, steps: int, device, params=None) -> list[float]:
    """Loss per step of ``steps`` train steps under ``policy`` from
    ``params`` (default ``model.init(0)``)."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), **SHAPE).with_policy(policy)
    model = build_model(cfg, device=device)
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps))
    step = make_train_step(model, tcfg)
    params = model.init(0) if params is None else params
    state = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    losses = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.next_batch().items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def main(argv=None, *, params=None) -> dict:
    """``params``: initial parameters of every run (e.g. converted from
    another package's draws); default ``model.init(0)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"training the same model under {len(POLICIES)} precision policies, "
          f"{args.steps} steps, device={dev}")
    curves = {}
    for name, pol in POLICIES.items():
        curves[name] = run(pol, args.steps, dev, params)
        print(f"  {name:34s} loss {curves[name][0]:.3f} -> "
              f"{np.mean(curves[name][-TAIL:]):.3f}")
    base = np.mean(curves[BASELINE][-TAIL:])
    gaps = {}
    for name, losses in curves.items():
        gaps[name] = float(np.mean(losses[-TAIL:]) - base)
        print(f"  final-loss gap vs baseline: {name:34s} {gaps[name]:+.4f}")
    return {"device": str(dev), "steps": args.steps, "curves": curves, "gaps": gaps}


if __name__ == "__main__":
    main()
