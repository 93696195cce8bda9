"""One run of one cell: set-up, the measured window, the traced readings,
the check against the reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (the engine's spans on, ``torch.profiler`` over the whole
window).  Both check ``correct`` the same way.
The last line of standard output is the result; the numbers ``correct``
compared, each beside its limit, end standard error.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

from harness import check, drive, kcache, spec, trace

#: the port and its neighbours that must not be loaded: compared by whole
#: top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """Everything a metric reader may read of one run."""

    def __init__(self, cell: spec.Cell, sz, tl: drive.Timeline, setup_s: float):
        self.cell, self.sizes, self.timeline, self.setup_s = cell, sz, tl, setup_s
        self.traffic = cell.traffic
        self.mode = cell.config["serving"]["mode"]
        self.device_trace: trace.DeviceTrace | None = None
        self.prefills: list[trace.Span] = []
        self.decodes: list[trace.Span] = []
        #: "built" or "cached" (``kcache.load``) on the GPU
        self.kernel_build: str | None = None


def serve(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
          t_start: float, mode: str | None = None, build_dir: Path | None = None,
          impl: str | None = None):
    """Set up the engine and serve the window.  Returns (run, params, peak
    bytes); the engine is freed."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.obs import TraceConfig
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    sz, tr = cell.sizes, cell.traffic
    kernel_build = kcache.load(build_dir) if device == "cuda" else None
    params = cell.family.weights(sz, seed, device)
    model = build_model(spec.arch_of(cell, mode, impl), device=device)
    engine = ServeEngine(model, params, config=ServeConfig(
        batch_slots=tr["slots"], max_len=tr["max_len"],
        trace=TraceConfig(capacity=1 << 22) if traced else None))
    load = spec.traffic_kind(cell).Load(tr, seed, sz.vocab, seconds)
    drv = drive.Driver(engine, load, lambda p, n, rid: Request(p, n, rid))
    drv.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    prof = profiled(drv) if traced and device == "cuda" else None
    drv.window(seconds)
    if device == "cuda":
        torch.cuda.synchronize()
    run = Run(cell, sz, drv.tl, setup_s)
    run.kernel_build = kernel_build
    if prof is not None:
        prof.__exit__(None, None, None)
        run.device_trace = trace.from_profiler(prof, drv.on_step.starts, drv.tl.t_open,
                                               drv.tl.t_close)
    if traced:
        run.prefills = trace.engine_spans(engine.tracer, "prefill")
        run.decodes = trace.engine_spans(engine.tracer, "decode_step")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    engine.close()
    del engine, model, drv
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return run, params, peak


def profiled(drv: drive.Driver):
    """``torch.profiler`` started before the window opens (its start-up
    stays outside it) and stopped by the caller once the window has
    closed; the driver records the host start of every profiled step."""
    from torch.profiler import ProfilerActivity, profile

    def on_step(st: drive.Step) -> None:
        on_step.starts.append(st.t0)

    on_step.starts = []
    drv.on_step = on_step
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def report(run: Run, traced: bool) -> tuple[dict, dict | None]:
    """The metrics this cell reports in this run, each from its reader; a
    reader that finds nothing to read is left out."""
    metrics = {}
    for m in run.cell.metrics(traced):
        value = spec.metric_reader(run.cell, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    brk = None
    if traced and run.device_trace is not None:
        brk = trace.breakdown(run.device_trace, run.prefills + run.decodes)
    return metrics, brk


def judge(run: Run, params: dict, seed: int, device) -> tuple[bool, dict]:
    """Readings of the reference check and whether each is within its limit."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr, fam, sz = run.traffic, run.cell.family, run.sizes
    coupled = fam.coupled_rows(sz)
    rids = check.judged(run.timeline, coupled, tr["judge_requests"], seed)
    rep = fam.Replay(sz, params, tr["slots"], tr["max_len"], device)
    got = check.readings(run.timeline, rep, coupled, tr["slots"], rids, device)
    limits = run.cell.limits["limits"]
    compared = {name: {"value": got[name], "limit": lim} for name, lim in limits.items()}
    ok = got["tokens_judged"] > 0 and all(c["value"] <= c["limit"] for c in compared.values())
    compared["tokens_judged"] = {"value": got["tokens_judged"], "limit": "> 0"}
    for name, value in got.items():
        compared.setdefault(name, {"value": value, "limit": "reported"})
    return ok, compared


def attempted(tl: drive.Timeline) -> int:
    """Requests in the system during the window: due before it closed and
    not finished before it opened."""
    return sum(1 for rid, due in tl.due.items()
               if due < tl.t_close and not (tl.token_t[rid] and tl.done(rid)
                                            and tl.token_t[rid][-1] <= tl.t_open))


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch

    cell = spec.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_dir = Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    run, params, peak = serve(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_start, build_dir=build_dir)
    metrics, brk = report(run, bool(args.trace))
    ok, compared = judge(run, params, args.seed, "cuda")
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules that must not be loaded are: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(peak)}
    if args.trace and run.device_trace is not None:
        device["busy_s"] = run.device_trace.busy_s()
        device["window_s"] = run.device_trace.window_s
    tl = run.timeline
    result = {"correct": ok, "attempted": attempted(tl), "failed": 0, "metrics": metrics,
              "device": device}
    if brk is not None:
        result["breakdown"] = brk
    # "built" marks the run that compiled the kernels: its setup_s holds the build
    result["kernel_build"] = run.kernel_build
    result["compared"] = compared
    for name, c in compared.items():
        print(f"{name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0
