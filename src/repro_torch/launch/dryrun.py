"""Multi-pod dry-run: trace every (architecture x shape x mesh) cell on fake
tensors over a fake process group, prove the sharding is coherent, and
count the roofline terms.

The reference's ``repro.launch.dryrun`` (``src/repro/launch/dryrun.py``) on
the port.  Where the reference lowers and compiles each cell for 512
placeholder devices, this runs the step once, in one process, as rank 0 of
a fake world of 256 (``pod16x16``) or 512 (``pod2x16x16``) ranks
(``torch.testing._internal.distributed.fake_pg``: backend ``"fake"``, no
traffic) on ``make_production_mesh``, with every tensor a fake tensor
(nothing allocated), under the op recorder (``launch.op_cost``), which
also tracks the storages the step's ops make (its peak temp bytes)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8 --cell-timeout 900

Each cell writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>__<policy>.json``
(per-device argument, output and peak temp bytes, the counted cost and its
roofline terms).  Counts, not measurements: nothing runs on a device.  The
memory term reads eager-dispatch bytes (each op one pass over memory), the
traffic of this implementation rather than the least the step must move.
Nothing here runs at import: ``run_cell`` makes the process group and
destroys it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import oprecord
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import PRESETS
from repro_torch.distributed.sharding import put
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (
    SHAPES,
    build_cell,
    cell_applicable,
    count_params,
    model_flops,
)
from repro_torch.plan.cost import PEAK_FLOPS

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake group of ``world`` ranks (no traffic:
    collectives on fake tensors only take their shapes), destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(value) -> int:
    """Bytes one device holds of a tree of (D)Tensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(value, DTensor):
        return _local_bytes(value.to_local())
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, dict):
        return sum(_local_bytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(_local_bytes(v) for v in value)
    if dataclasses.is_dataclass(value):
        return sum(_local_bytes(getattr(value, f.name)) for f in dataclasses.fields(value))
    return 0


@contextlib.contextmanager
def _strided_shards_on_host():
    """DTensor works out a strided shard's local size from an index tensor
    it reads with ``.tolist()`` (``_StridedShard.local_shard_size_and_offset``
    in torch 2.13); under the dry run's fake mode that tensor is fake and
    cannot be read.  Inside this context it is made as a real host tensor,
    and its ops are not recorded: they are DTensor's bookkeeping, not the
    step's work."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    fn = cls.__dict__.get("local_shard_size_and_offset") if cls is not None else None
    if fn is None:
        yield
        return

    def on_host(*args, **kwargs):
        with unset_fake_temporarily(), oprecord.suspended():
            return fn(*args, **kwargs)

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = fn


def trace_cell(cell: dict, mesh) -> tuple[op_cost.CostRecorder, dict, float]:
    """Lay the cell's arguments out and run its step once under the recorder:
    (recorder, memory, seconds).  The peak temp bytes are the recorder's
    (``track_memory``): the storages the step's own ops make, alive at once.
    (``torch.distributed._tools.mem_tracker.MemTracker`` also counts the
    whole-tensor fakes DTensor makes to propagate shapes: 106 GB a device
    for the smoke qwen train cell.)"""
    from repro_torch.train.step import mesh_scope

    t0 = time.perf_counter()
    with cell["fake_mode"]:
        args = tuple(put(a, s) for a, s in zip(cell["args"], cell["in_shardings"]))
        rec = op_cost.CostRecorder(keep=False, track_memory=True)
        with _strided_shards_on_host(), mesh_scope(mesh), rec:
            out = cell["fn"](*args)
    memory = dict(
        argument_bytes=_local_bytes(args),
        output_bytes=_local_bytes(out),
        temp_bytes=rec.peak_bytes,
    )
    return rec, memory, time.perf_counter() - t0


def _cell_id(arch, shape_name, multi_pod, policy, grad_compression, kv_int8, smoke) -> str:
    cell_id = f"{arch}__{shape_name}__{'pod2x16x16' if multi_pod else 'pod16x16'}__{policy}"
    for on, tag in ((grad_compression, "gradcomp"), (kv_int8, "kvint8"), (smoke, "smoke")):
        if on:
            cell_id += f"__{tag}"
    return cell_id


def run_cell(arch: str, shape_name: str, multi_pod: bool, policy: str = "paper_baseline",
             out_dir: str = OUT_DIR, grad_compression: bool = False,
             kv_int8: bool = False, smoke: bool = False) -> dict:
    """One cell's record (written to ``out_dir``).  ``smoke`` takes the
    arch's smoke config (tests); a failure is recorded, not raised."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = _cell_id(arch, shape_name, multi_pod, policy, grad_compression, kv_int8, smoke)
    shape = SHAPES[shape_name]
    cfg = (get_smoke_config(arch) if smoke else get_config(arch)).with_policy(PRESETS[policy])
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    ok, reason = cell_applicable(cfg, shape)
    record: dict = {
        "cell": cell_id, "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "policy": policy, "chips": 512 if multi_pod else 256,
    }
    if not ok:
        record["status"] = "n/a"
        record["reason"] = reason
        _write(out_dir, cell_id, record)
        return record
    try:
        with fake_world(record["chips"]):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            cell = build_cell(cfg, shape, mesh, grad_compression=grad_compression)
            rec, memory, t_trace = trace_cell(cell, mesh)
        cost = rec.cost
        terms = op_cost.roofline_terms(cost)
        params = cell["args"][0]["params"] if shape.kind == "train" else cell["args"][0]
        counts = count_params(params, cell["cfg"])
        mf = model_flops(cell["cfg"], shape, params)
        chips = record["chips"]
        dom_t = max(terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"])
        record.update(
            status="ok",
            t_trace_s=round(t_trace, 1),
            n_events=rec.n_events,
            memory=memory,
            roofline=terms,
            params=counts,
            model_flops_global=mf,
            useful_flops_ratio=mf / (cost.flops * chips) if cost.flops else 0.0,
            roofline_fraction_estimate=(mf / chips / PEAK_FLOPS) / dom_t if dom_t else 0.0,
        )
    except Exception as e:  # a failure here is a sharding or tracing bug
        record["status"] = "fail"
        record["error"] = f"{type(e).__name__}: {e}"[:2000]
        record["traceback"] = traceback.format_exc()[-3000:]
    _write(out_dir, cell_id, record)
    return record


def _write(out_dir: str, cell_id: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default="paper_baseline", choices=tuple(PRESETS))
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="with --jobs: seconds before a cell is stopped and recorded "
                         "as 'timeout'")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    units = [(arch, shape, mp) for arch, shape in cells for mp in meshes]
    if args.jobs > 1:
        records = run_cells(units, jobs=args.jobs, policy=args.policy, out=args.out,
                            grad_compression=args.grad_compression, kv_int8=args.kv_int8,
                            cell_timeout=args.cell_timeout)
    else:
        records = []
        for arch, shape, mp in units:
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, mp, args.policy, args.out,
                           args.grad_compression, args.kv_int8)
            _report(rec, time.perf_counter() - t0)
            records.append(rec)
    n_fail = sum(rec["status"] in ("fail", "timeout") for rec in records)
    print(f"done; failures: {n_fail}")
    return 1 if n_fail else 0


def _report(rec: dict, seconds: float) -> None:
    dom = rec.get("roofline", {}).get("dominant", "-")
    print(f"[{rec['status']:4s}] {rec['cell']:70s} {seconds:6.1f}s dominant={dom}", flush=True)
    if rec["status"] in ("fail", "timeout"):
        print(rec["error"], flush=True)


def run_cells(units, *, jobs: int, policy: str = "paper_baseline", out: str = OUT_DIR,
              grad_compression: bool = False, kv_int8: bool = False,
              cell_timeout: float | None = None, env: dict | None = None) -> list[dict]:
    """Each (arch, shape, multi_pod) of ``units`` by this module's CLI in a
    process of its own, ``jobs`` at a time (``env`` added to this process's
    environment), its output in ``out/<cell>.log``; a cell past
    ``cell_timeout`` seconds is stopped and recorded as ``timeout``, one
    that wrote no record as ``fail``."""
    import subprocess
    import sys

    flags = ["--policy", policy, "--out", out]
    flags += ["--grad-compression"] * grad_compression + ["--kv-int8"] * kv_int8
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    os.makedirs(out, exist_ok=True)
    todo, running, records = list(units), [], []
    while todo or running:
        while todo and len(running) < jobs:
            arch, shape, mp = todo.pop(0)
            cell_id = _cell_id(arch, shape, mp, policy, grad_compression, kv_int8, False)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, *(["--multi-pod"] if mp else []), *flags]
            log = open(os.path.join(out, cell_id + ".log"), "w")
            running.append(((arch, shape, mp, cell_id), time.perf_counter(), log,
                            subprocess.Popen(cmd, env=env, stdout=log,
                                             stderr=subprocess.STDOUT)))
        time.sleep(0.5)
        for item in list(running):
            (arch, shape, mp, cell_id), t0, log, proc = item
            late = cell_timeout is not None and time.perf_counter() - t0 > cell_timeout
            if proc.poll() is None and not late:
                continue
            running.remove(item)
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
            path = os.path.join(out, cell_id + ".json")
            rec = {"cell": cell_id, "arch": arch, "shape": shape,
                   "mesh": "pod2x16x16" if mp else "pod16x16", "policy": policy,
                   "chips": 512 if mp else 256}
            if late:
                rec.update(status="timeout", error=f"not finished in {cell_timeout:.0f} s")
                _write(out, cell_id, rec)
            elif os.path.exists(path):
                with open(path) as fh:
                    rec = json.load(fh)
            else:
                with open(log.name) as fh:
                    tail = fh.read()[-2000:]
                rec.update(status="fail", error=f"exit {proc.returncode}, no record: {tail}")
                _write(out, cell_id, rec)
            _report(rec, time.perf_counter() - t0)
            records.append(rec)
    return records


if __name__ == "__main__":
    raise SystemExit(main())
