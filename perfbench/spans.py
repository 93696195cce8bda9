#!/usr/bin/env python3
"""The program's own spans in traced runs, several seeds in one process.

    python3 perfbench/spans.py --workload <cell> --seeds 1,2,3 --seconds 51 [--out f.jsonl]

Each seed is a whole traced run of the cell, as ``run.py --trace 1`` makes
it (the engine's spans on, ``torch.profiler`` over the window) and checked
the same way; the engine's events are kept when it closes.  One JSON line a
seed: the cell's per-layer metrics and breakdown as ``run.py`` reports them,
the device time of the decode step's replay and of its blocks and of the
prefill's scatter (``harness/sites.py``: medians over the window's steps),
the median device ms of every device span, the median host ms of each
kind of engine span,
the steps whose blocks read more than their replay (none may), the idle
gaps by the innermost engine span at their middle, and the device time of
the longest operations inside the prefills and the decode steps.  The benchmark's own
runs never run this.

A stopgap: ``harness/main.py``'s ``serve()`` frees the engine before its
readers run, so this second runner repeats its serve, report and judge
sequence and catches the events at ``close()``.  Once ``serve()`` keeps the
engine's events on the ``Run`` and readers over ``harness/sites.py`` report
the per-block metrics (ROADMAP, the ``benchmark`` follow-up of the engine's
spans), this script goes, with the helpers of ``sites.py`` that only it
reads: ``host_ms``, ``all_sites_ms``, ``ops_by_span`` and
``blocks_over_replay``.
"""
import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

from harness import main, sites, spec

HERE = Path(__file__).resolve().parent
#: where ``run.py`` keeps the port's kernel library
KERNELS = HERE.parent / "build" / "perfbench" / "kernels"

#: (name, kind, device span) of each median reading
READINGS = (("attention_ms.decode", "decode_step", "attention"),
            ("ffn_ms.decode", "decode_step", "ffn"),
            ("state_write_ms.decode", "decode_step", "state"),
            ("scatter_row_ms.prefill", "prefill", "scatter"))


@contextlib.contextmanager
def kept_events(kept: list):
    """While open, every engine ``main.serve`` builds hands its tracer's
    events to ``kept`` when it closes."""
    import repro_torch.serve as serve_mod

    base = serve_mod.ServeEngine

    class Keeping(base):
        def close(self):
            kept[:] = list(self.tracer.events)
            super().close()

    serve_mod.ServeEngine = Keeping
    try:
        yield
    finally:
        serve_mod.ServeEngine = base


def readings(events, run) -> dict:
    tl = run.timeline
    out = {"replay_device_ms.decode": sites.replay_device_ms(events, tl.t_open, tl.t_close)}
    for name, kind, site in READINGS:
        out[name] = sites.site_ms(events, kind, site, tl.t_open, tl.t_close)
    return out


def spans_runs(workload: str, seeds: list[int], seconds: float, device: str = "cuda",
               root: Path = spec.ROOT, out_path: str | None = None,
               build_dir: Path = KERNELS) -> list[dict]:
    cell = spec.load_cell(workload, root)
    out = []
    for seed in seeds:
        events: list = []
        with kept_events(events):
            run, params, peak = main.serve(cell, seed, seconds, True, device, time.perf_counter(),
                                           build_dir=build_dir)
        metrics, brk = main.report(run, True)
        ok, _ = main.judge(run, params, seed, device)
        tl = run.timeline
        steps = sites.spans(events, "decode_step", tl.t_open, tl.t_close)
        line = {"workload": workload, "seed": seed, "correct": ok, "peak_bytes": peak,
                "metrics": {k: v["value"] for k, v in metrics.items()},
                "sites": readings(events, run),
                "decode_steps": len(steps),
                "pairs_per_step": sum(steps[-1].get("sites_n", {}).values()) if steps else None,
                "host_ms": sites.host_ms(events, tl.t_open, tl.t_close),
                "sites_ms": {kind: sites.all_sites_ms(events, kind, tl.t_open, tl.t_close)
                             for kind in ("decode_step", "prefill")},
                "blocks_over_replay": sites.blocks_over_replay(events),
                "breakdown": brk}
        if run.device_trace is not None:
            line["idle_by_span"] = sites.idle_by_span(run.device_trace, events)
            line["ops_by_span"] = sites.ops_by_span(run.device_trace, events)
        out.append(line)
        print(json.dumps(line), flush=True)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(line) + "\n")
        del params, events
    return out


if __name__ == "__main__":
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(KERNELS)
    sys.path.insert(1, str(HERE.parent / "src"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    spans_runs(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
               out_path=args.out)
