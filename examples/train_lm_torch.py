"""End-to-end training on the PyTorch/CUDA port: a small qwen-family model
trained for a few hundred steps on synthetic data, with checkpoint/restart
fault tolerance.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --fresh
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --resume   # restart
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20 --fresh

The port's counterpart of ``examples/train_lm.py``: the same shapes, data
(``SyntheticLM`` seed 0), optimizer and loop, through ``train.loop.train_loop``,
``resume_or_init`` and the checkpoint manager.  ``--stop-at S`` ends the run
after step S as a preemption would (the learning-rate schedule still spans
``--steps``), so a later ``--resume`` continues it.  The model runs with the
RMPM engine policy given by ``--policy``; gradients flow through the plain
limb algebra, since the hand-written kernels have no backward pass (as the
reference's Pallas kernels have none).  Without ``--device`` it runs on the
GPU and raises when there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

import numpy as np

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.policy import PRESETS
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.train import put_batch_on
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, resume_or_init, train_loop
from repro_torch.train.step import TrainConfig, make_train_step

#: the reference's qwen1.5-0.5b topology, trimmed in vocab and width
SHAPE = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024, vocab=2048,
             remat=False, attn_chunk=128)
SEQ, BATCH = 128, 8
CHECKPOINT_EVERY, LOG_EVERY = 100, 20
#: the loss is judged on the means of the first and last WINDOW steps
WINDOW = 10
DEFAULT_CKPT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "train_lm_torch")


def init_state(model, tcfg: TrainConfig, params=None) -> dict:
    """A fresh train state: ``params`` (default ``model.init(0)``) and
    AdamW's zero moments."""
    params = model.init(0) if params is None else params
    return {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}


def main(argv=None, *, params=None) -> dict:
    """``params``: initial parameters of a fresh run (e.g. converted from
    another package's draws); default ``model.init(0)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--policy", default="native_f32", choices=tuple(PRESETS))
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="end after this step, as a preemption would")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), **SHAPE)
    cfg = cfg.with_policy(PRESETS[args.policy])
    model = build_model(cfg, device=dev)
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        accum_steps=1)
    train_step = make_train_step(model, tcfg)

    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    start, state = resume_or_init(
        mgr if args.resume else None, lambda: init_state(model, tcfg, params), device=dev)
    if start:
        print(f"resumed from step {start} (elastic restore; data skip-ahead)")
        data.skip_to(start)
    n_params = sum(x.numel() for x in tree.leaves(state["params"]))
    print(f"model: {n_params/1e6:.1f}M params, policy={cfg.policy.describe()}, device={dev}")

    end = args.steps if args.stop_at is None else min(args.stop_at, args.steps)
    state, history = train_loop(
        train_step, state, data,
        LoopConfig(total_steps=end, checkpoint_every=CHECKPOINT_EVERY, log_every=LOG_EVERY),
        ckpt_manager=mgr, start_step=start,
        put_batch=put_batch_on(dev),
        on_metrics=lambda r: print(
            f"  step {r['step']:4d} loss={r['loss']:.4f} gnorm={r['grad_norm']:.2f} "
            f"dt={r['dt']*1e3:.0f}ms{' STRAGGLER' if r['straggler'] else ''}"
        ),
    )
    losses = [h["loss"] for h in history]
    stragglers = [h["step"] for h in history if h["straggler"]]
    # a cut or short run is not judged: its two windows would overlap
    judged = end == args.steps and len(losses) >= 2 * WINDOW
    first = float(np.mean(losses[:WINDOW])) if losses else float("nan")
    last = float(np.mean(losses[-WINDOW:])) if losses else float("nan")
    improved = last < first
    print(f"loss: {first:.3f} -> {last:.3f}  "
          f"(improved: {improved if judged else 'not judged, a cut or short run'})")
    print(f"straggler steps flagged: {stragglers[:5]}{'...' if len(stragglers) > 5 else ''}")
    print(f"checkpoints: {mgr.all_steps()}")
    if judged and not improved:
        raise RuntimeError("training must reduce loss on the synthetic chain")
    return {"device": str(dev), "n_params": n_params, "start": start, "end": end,
            "steps": [h["step"] for h in history], "losses": losses,
            "first": first, "last": last, "judged": judged, "improved": improved,
            "stragglers": stragglers, "checkpoints": mgr.all_steps()}


if __name__ == "__main__":
    main()
