"""Fault-tolerant checkpointing: async save thread, atomic commit, keep-K GC,
SIGTERM emergency save, restore onto an explicit device.

The reference's format, so either package can read the other's files: one
``.npz`` per process (one process until ROADMAP A13) + ``manifest.json``
with the step, the array count and bytes, under ``step_%08d/``, written to
``.tmp_step_%08d`` and committed by ``os.rename``.  Keys are tree paths
(``params/layers/seg0_dense/attn/wq/w``; a tuple's items are ``[i]``).
``save`` copies every tensor to host memory before it returns, so the
caller may go on updating its state while the thread writes.  NumPy has no
bfloat16: a bf16 leaf is refused rather than written as something else.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

#: process index and count of the shard layout (one process until A13)
PROCESS_INDEX, PROCESS_COUNT = 0, 1


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/[{i}]"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("[") for k in node):
            return tuple(fix(node[f"[{i}]"]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_host(path: str, x: Any) -> np.ndarray:
    """A leaf as a host array: a tensor is copied off its device."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {path!r} is bfloat16, which numpy cannot hold; "
                "cast it to float32 before saving")
        # a copy even on the CPU, where ``.cpu()`` would share the buffer
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, block: bool = False) -> None:
        # Snapshot to host memory synchronously: the caller's tensors may
        # be replaced or updated as soon as this returns.
        flat = {k: _to_host(k, v) for k, v in _flatten(state).items()}
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, flat)

    def _write(self, step: int, flat: dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.directory, f".tmp_step_{step:08d}")
        final = os.path.join(self.directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{PROCESS_INDEX:05d}.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_arrays": len(flat),
            "bytes": int(sum(v.nbytes for v in flat.values())),
            "process_count": PROCESS_COUNT,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.directory, name, "manifest.json")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device=None) -> tuple[int, Any]:
        """The state saved at ``step`` (default: the latest), every leaf a
        tensor on ``device`` (None: the GPU, raising when there is none)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        dev = resolve_device(device)
        path = os.path.join(self.directory, f"step_{step:08d}")
        with np.load(os.path.join(path, f"shard_{PROCESS_INDEX:05d}.npz")) as z:
            flat = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
        return step, _unflatten(flat)

    # -- fault tolerance hooks --------------------------------------------------

    def install_sigterm_handler(self, get_state) -> None:
        """On SIGTERM (preemption), write an emergency checkpoint before exit."""

        def handler(signum, frame):
            step, state = get_state()
            self.save(step, state, block=True)
            raise SystemExit(128 + signum)

        signal.signal(signal.SIGTERM, handler)
