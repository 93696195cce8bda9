"""Training loop with fault tolerance and straggler monitoring.

Fault tolerance model (the reference's):
  * periodic async checkpoints + atomic commit (checkpoint.manager)
  * SIGTERM emergency save (preemption)
  * elastic resume: restore the latest checkpoint onto the given device
    or resharded onto the current mesh, deterministic data skip-ahead
  * straggler monitor: per-step wall-time EWMA; steps beyond
    ``straggler_z`` sigma are logged with the step index — on a real fleet
    this feeds the scheduler's replace-worker decision

A step's ``dt`` ends with a synchronize on the loss's device, so it is the
step's real time and not the time to enqueue it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_z: float = 3.0
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.1
    z_threshold: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= 3:  # warmup: first steps (allocator, kernels' first use) are outliers
            self.mean = dt
            self.var = 0.0
            return False
        z = (dt - self.mean) / (self.var**0.5 + 1e-9) if self.var > 0 else 0.0
        is_straggler = self.n > 8 and z > self.z_threshold
        if is_straggler:
            self.flagged.append((step, dt, z))
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


def _wait_for(x: Any) -> None:
    """Block until ``x`` (a tensor) has been computed on its device."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def train_loop(
    train_step: Callable,
    state: Any,
    data: Iterator[dict[str, np.ndarray]] | Any,
    loop_cfg: LoopConfig,
    *,
    ckpt_manager=None,
    start_step: int = 0,
    put_batch: Callable | None = None,
    on_metrics: Callable | None = None,
    adapt=None,
) -> tuple[Any, list[dict]]:
    """Generic loop; ``data`` provides ``next_batch()`` or is an iterator.

    ``put_batch`` turns a host batch (numpy) into the step's input (tensors
    on the device).  ``adapt`` (``repro_torch.adapt.TrainPrecisionSchedule``)
    turns on the grad-norm-drift precision schedule: the step is then called
    as ``train_step(state, batch, mode_scalars)`` — a *modal* step
    (``train.step.make_modal_step``) whose call-sites read the modes through
    ``bind_modes`` — and the schedule observes each step's metrics to shift
    the mode table between steps.
    """
    monitor = StragglerMonitor(alpha=loop_cfg.ewma_alpha, z_threshold=loop_cfg.straggler_z)
    history: list[dict] = []
    step = start_step
    if ckpt_manager is not None:
        latest = {"step": step, "state": state}
        ckpt_manager.install_sigterm_handler(lambda: (latest["step"], latest["state"]))

    while step < loop_cfg.total_steps:
        batch = data.next_batch() if hasattr(data, "next_batch") else next(data)
        if put_batch is not None:
            batch = put_batch(batch)
        t0 = time.perf_counter()
        if adapt is not None:
            state, metrics = train_step(state, batch, adapt.mode_scalars())
        else:
            state, metrics = train_step(state, batch)
        _wait_for(metrics["loss"])
        dt = time.perf_counter() - t0
        step += 1
        straggle = monitor.observe(step, dt)
        rec = {
            "step": step,
            "dt": dt,
            "straggler": straggle,
            **{k: float(v) for k, v in metrics.items()},
        }
        if adapt is not None:
            shift = adapt.observe(step, rec, dt)
            rec["mode"] = adapt.table.label()
            rec["mode_shift"] = shift
        history.append(rec)
        if on_metrics is not None and step % loop_cfg.log_every == 0:
            on_metrics(rec)
        if ckpt_manager is not None:
            latest = {"step": step, "state": state}
            if step % loop_cfg.checkpoint_every == 0 or step == loop_cfg.total_steps:
                ckpt_manager.save(step, state)
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return state, history


def resume_or_init(ckpt_manager, init_fn: Callable[[], Any], device=None,
                   shardings: Any = None) -> tuple[int, Any]:
    """Elastic resume: restore the latest checkpoint onto ``device`` (None:
    the GPU), resharded by ``shardings`` onto the current mesh when given,
    or initialize fresh."""
    if ckpt_manager is not None and ckpt_manager.latest_step() is not None:
        return ckpt_manager.restore(device=device, shardings=shardings)
    return 0, init_fn()
