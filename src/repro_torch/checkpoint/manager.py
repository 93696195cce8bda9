"""Fault-tolerant checkpointing: async save thread, atomic commit, keep-K GC,
SIGTERM emergency save, elastic restore (onto a device, or resharded onto
the current mesh whatever mesh saved it).

The reference's format, so either package can read the other's files:
``shard_00000.npz`` holding every array whole + ``manifest.json`` with
the step, the array count and bytes and the process count, under
``step_%08d/``, written to ``.tmp_step_%08d`` and committed by
``os.rename``.  Keys are tree paths (``params/layers/seg0_dense/attn/wq/w``;
a tuple's items are ``[i]``).  ``save`` copies every tensor to host memory
before it returns, so the caller may go on updating its state while the
thread writes.  In a multi-process run rank 0 alone holds the arrays and
writes them: a ``DTensor``'s parts are sent to rank 0 (a collective among
its mesh's ranks, so every rank calls ``save``), and ``wait`` holds every
rank until the commit is visible.  Every rank restores from the one file,
each moving only its own part of a sharded leaf to its device.  NumPy has
no bfloat16: a bf16 leaf is refused rather than written as something else.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import signal
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard_slices

#: the file that holds the arrays (the reference's shard of process 0)
_SHARD = "shard_00000.npz"


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


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


def _host_copy(x: torch.Tensor) -> np.ndarray:
    # a copy even on the CPU, where ``.cpu()`` would share the buffer
    return x.detach().to("cpu", copy=True).numpy()


def _gather_to_rank0(x: DTensor) -> np.ndarray | None:
    """A DTensor whole, on rank 0's host, as a host array; None elsewhere.
    Of the ranks of rank 0's mesh, one per distinct part sends it to rank 0
    (the others, and ranks whose mesh holds another pod's copy, send
    nothing), and no rank but rank 0 holds more than its own part."""
    mesh, placements = x.device_mesh, tuple(x.placements)
    ranks = mesh.mesh
    me = process_index()
    if not bool((ranks == 0).any()):
        return None
    local = x.to_local()
    one_part = all(not isinstance(p, Shard) or n == 1
                   for p, n in zip(placements, mesh.shape))
    out = None
    for coord in itertools.product(*(range(n) for n in mesh.shape)):
        if any(c and not isinstance(p, Shard) for c, p in zip(coord, placements)):
            continue  # a replica of a part another coordinate sends
        src = int(ranks[coord])
        where = shard_slices(x.shape, placements, mesh.shape, coord)
        if me == 0:
            if src == 0:
                part = local
            else:
                part = torch.empty([s.stop - s.start for s in where], dtype=x.dtype,
                                   device=local.device)
                dist.recv(part, src=src)
            if one_part:
                return _host_copy(part)
            if out is None:
                dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
                out = np.empty(tuple(x.shape), dtype=dtype)
            out[where] = part.detach().cpu().numpy()
        elif me == src:
            dist.send(local.detach().contiguous(), dst=0)
    return out


def _to_host(path: str, x: Any) -> np.ndarray | None:
    """A leaf as a host array on rank 0 (None on the other ranks): a tensor
    is copied off its device, a DTensor gathered whole to rank 0 first (a
    collective among its mesh's ranks, so every rank calls this)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        raise TypeError(
            f"checkpoint leaf {path!r} is bfloat16, which numpy cannot hold; "
            "cast it to float32 before saving")
    if isinstance(x, DTensor):
        return _gather_to_rank0(x)
    if process_index() != 0:
        return None
    if isinstance(x, torch.Tensor):
        return _host_copy(x)
    return np.asarray(x)


def _place(state: Any, shardings: Any) -> Any:
    if isinstance(state, dict):
        return {k: _place(v, shardings[k]) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_place(v, s) for v, s in zip(state, shardings, strict=True))
    return shardings.put(state)


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
        flat = {k: v for k, v in flat.items() if v is not None}
        self.wait()
        if process_index() == 0:
            if self.async_save and not block:
                self._thread = threading.Thread(
                    target=self._write, args=(step, flat), daemon=True
                )
                self._thread.start()
            else:
                self._write(step, flat)
        if block or not self.async_save:
            self.wait()

    def _write(self, step: int, flat: dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.directory, f".tmp_step_{step:08d}")
        final = os.path.join(self.directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, _SHARD), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_arrays": len(flat),
            "bytes": int(sum(v.nbytes for v in flat.values())),
            "process_count": process_count(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        """Until the last save is committed (on every rank of a multi-
        process run: a barrier, so every rank calls it)."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if process_count() > 1:
            dist.barrier()

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

    def restore(self, step: int | None = None, device=None,
                shardings: Any = None) -> tuple[int, Any]:
        """The state saved at ``step`` (default: the latest), every leaf a
        tensor on ``device`` (None: the GPU, raising when there is none).
        Elastic restore: with ``shardings`` (the state's tree of
        ``distributed.sharding.NamedSharding``) every leaf becomes a DTensor
        laid out so on the *current* mesh, whatever mesh saved it: each rank
        reads the whole array on its host and moves only its own part to its
        device (nothing is sent between ranks)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        dev = resolve_device(device)
        path = os.path.join(self.directory, f"step_{step:08d}")
        with np.load(os.path.join(path, _SHARD)) as z:
            flat = {k: torch.from_numpy(z[k]) for k in z.files}
        if shardings is not None:
            return step, _place(_unflatten(flat), shardings)
        return step, _unflatten({k: v.to(dev) for k, v in flat.items()})

    # -- fault tolerance hooks --------------------------------------------------

    def install_sigterm_handler(self, get_state) -> None:
        """On SIGTERM (preemption), write an emergency checkpoint before exit."""

        def handler(signum, frame):
            step, state = get_state()
            self.save(step, state, block=True)
            raise SystemExit(128 + signum)

        signal.signal(signal.SIGTERM, handler)
