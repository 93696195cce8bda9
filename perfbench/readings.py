#!/usr/bin/env python3
"""Readings for the limits of ``correct``, several seeds in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 40 [--mode M8]

Each seed is a whole run of the cell (its weights, set-up and window) and
its check against the reference; ``--mode M8`` serves it in the next
precision below the configuration's instead (the low-precision control,
which has to come out not correct); ``--fault`` plants one of
``faults.FAULTS`` under the timed path.  One JSON line a seed.  The
benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CACHE = HERE.parent / "build" / "perfbench"
os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import faults  # noqa: E402
from harness import main, spec  # noqa: E402


def readings(workload: str, seeds: list[int], seconds: float, mode: str | None,
             device: str = "cuda", root: Path = spec.ROOT, impl: str | None = None,
             fault: str | None = None) -> list[dict]:
    cell = spec.load_cell(workload, root)
    out = []
    for seed in seeds:
        with (faults.planted(fault, cell.sizes.vocab) if fault else contextlib.nullcontext()):
            run, params, peak = main.serve(
                cell, seed, seconds, False, device, time.perf_counter(), mode=mode, impl=impl,
                build_dir=Path(os.environ["REPRO_TORCH_BUILD_DIR"]))
        metrics, _ = main.report(run, False)
        t = time.perf_counter()
        ok, compared = main.judge(run, params, seed, device)
        out.append({"workload": workload, "seed": seed, "impl": impl, "fault": fault,
                    "mode": mode or cell.config["serving"]["mode"],
                    "correct": ok, "reference_s": time.perf_counter() - t, "peak_bytes": peak,
                    "metrics": {k: v["value"] for k, v in metrics.items()},
                    "compared": {k: v["value"] for k, v in compared.items()}})
        print(json.dumps(out[-1]), flush=True)
        del params
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default=None)
    ap.add_argument("--impl", default=None, help="'native': one plain f32 matmul a site")
    ap.add_argument("--fault", default=None, choices=faults.FAULTS)
    args = ap.parse_args()
    readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, args.mode,
             impl=args.impl, fault=args.fault)
