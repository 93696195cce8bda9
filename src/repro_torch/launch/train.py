"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 50 --policy native_f32 --ckpt-dir /tmp/repro_ckpt

The model trains on the GPU; ``--device cpu`` (with ``--smoke``, the
reduced config) runs on the CPU.  The flags are the reference's
(``repro.launch.train``): ``--accuracy`` lets the matmul planner derive the
policy, ``--ckpt-dir`` checkpoints every ``--checkpoint-every`` steps and
resumes from the latest, ``--adapt`` runs the grad-norm-drift precision
schedule (``--slo-err``, ``--slo-ms``).  Gradients flow through the plain
limb algebra (``impl='xla'``) or one f32 product per site (``'native'``);
a policy or plan that sends a site to the hand-written kernels
(``'pallas'``, ``'tile'``) raises ``NotImplementedError`` there, as the
reference's ``jax.grad`` through a Pallas kernel does.

``--mesh D,M`` trains over a (data=D, model=M) ``DeviceMesh`` under
``torchrun`` with D*M processes, NCCL on the GPU (one per process) or gloo
with ``--device cpu``:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen1.5-0.5b --smoke --device cpu --mesh 2,2 --steps 3

Parameters, moments and inputs are laid out by ``distributed.sharding``'s
rules (the reference launcher's shardings), a checkpoint resumes resharded
onto the current mesh whatever mesh wrote it, and rank 0 prints.  A world
size other than D*M is an error.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import PRESETS
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.device import backend_of, resolve_device
from repro_torch.distributed.sharding import put
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, resume_or_init, train_loop
from repro_torch.train.step import (
    TrainConfig,
    init_train_state,
    make_modal_step,
    make_train_step,
    state_shardings,
)


def put_batch_on(device):
    """``put_batch`` for ``train_loop``: a numpy batch as tensors on
    ``device``."""
    def put(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return put


def mode_timeline(hist: list[dict]) -> list[str]:
    """The modes a run went through, each once per stretch."""
    modes = [h["mode"] for h in hist if "mode" in h]
    timeline = modes[:1]
    for m in modes[1:]:
        if m != timeline[-1]:
            timeline.append(m)
    return timeline


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced CPU-scale config")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises when there is none)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--policy", default="native_f32", choices=tuple(PRESETS))
    ap.add_argument(
        "--accuracy", type=float, default=0.0,
        help="relative-error budget for bulk GEMMs; when set, the matmul "
             "planner (repro_torch.plan) derives the precision policy from the "
             "cost model instead of --policy",
    )
    ap.add_argument(
        "--tune-table", default="",
        help="measured-cost tuning table (file or directory, repro_torch.tune) "
             "the planner resolves against; empty = TUNE_TABLE env var, "
             "then pure roofline",
    )
    ap.add_argument("--mesh", default="", help="e.g. '4,2' for (data=4, model=2), "
                    "under torchrun with that many processes")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument(
        "--adapt", action="store_true",
        help="grad-norm-drift precision schedule (repro_torch.adapt): the "
             "train step reads run-time mode scalars; the schedule relaxes "
             "precision down the RMPM ladder while the grad norm is stable "
             "and shifts it back up on drift spikes",
    )
    ap.add_argument("--slo-err", type=float, default=0.5,
                    help="adapt: max tolerated relative grad-norm drift")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="adapt: per-step latency target in ms (0 = none)")
    args = ap.parse_args()

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.with_policy(PRESETS[args.policy])
    mesh = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        device = init_distributed(args.device)
        mesh = make_mesh(shape, ("data", "model")[: len(shape)], device)
    else:
        device = resolve_device(args.device)  # None -> the GPU, or raise
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    if args.accuracy > 0:
        from repro_torch.plan import plan_model_policy

        planned, plans = plan_model_policy(
            cfg, tokens=args.batch * args.seq, accuracy=args.accuracy,
            backend=backend_of(device), tune_table=args.tune_table or None,
        )
        cfg = cfg.with_policy(planned)
        say(f"planned policy ({args.accuracy:.1e} budget): {planned.describe()}")
        for op, p in plans.items():
            say(f"  {op}: {p.describe()}")
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("use examples/ for multimodal drivers on CPU")
    model = build_model(cfg, device=device)
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                                    total_steps=args.steps),
        accum_steps=args.accum,
    )

    step_fn = make_train_step(model, tcfg, mesh)
    schedule = None
    if args.adapt:
        from repro_torch.adapt import SLO, ModeTable, TrainPrecisionSchedule

        table = ModeTable.from_policy(cfg.policy)
        schedule = TrainPrecisionSchedule(
            table, SLO(max_err=args.slo_err, target_ms=args.slo_ms or None))
        step_fn = make_modal_step(step_fn)
        say(f"adaptive precision schedule: start {table.describe()}")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch, seed=0)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mesh is None:
        start, state = resume_or_init(
            mgr, lambda: init_train_state(model, 0, tcfg), device=model.device)
    else:
        # every rank makes the same state from the seed and keeps its slices
        fresh = init_train_state(model, 0, tcfg)
        shardings = state_shardings(fresh["params"], cfg, mesh, tcfg)
        start, state = resume_or_init(mgr, lambda: put(fresh, shardings),
                                      device=model.device, shardings=shardings)
        del fresh
    if start:
        data.skip_to(start)
        say(f"resumed at step {start}")

    n = sum(x.numel() for x in tree.leaves(state["params"]))
    say(f"{args.arch}: {n/1e6:.1f}M params | policy {cfg.policy.describe()} | "
        f"mesh {args.mesh or 'single'} | device {model.device}")

    pf = Prefetcher(data)
    try:
        state, hist = train_loop(
            step_fn, state, pf,
            LoopConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every),
            ckpt_manager=mgr, start_step=start, adapt=schedule,
            put_batch=put_batch_on(model.device),
            on_metrics=lambda r: say(
                f"step {r['step']:5d} loss {r['loss']:.4f} gnorm {r['grad_norm']:.2f} "
                f"dt {r['dt']*1e3:.0f}ms"
                + (f" mode {r['mode']}" if "mode" in r else "")
                + (" STRAGGLER" if r["straggler"] else "")
            ),
        )
    finally:
        pf.close()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    say(f"loss {first:.4f} -> {last:.4f}")
    if schedule is not None:
        say(f"precision schedule: {' -> '.join(mode_timeline(hist))} "
            f"({schedule.table.switches} switches)")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
