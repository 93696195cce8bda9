#!/usr/bin/env python3
"""Find the knee of an open-loop cell once: serve it at several fixed rates
in one process and report, per rate, what was completed and how long the
queue grew.

    python3 perfbench/sweep.py --workload <open-loop cell> --rates 1.5,2,2.5,3 --seconds 30

The knee is the highest rate whose requests are all served in the window
with no backlog left growing; the cell runs at about four fifths of it, as
a number in its traffic file.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
os.environ["REPRO_TORCH_BUILD_DIR"] = str(HERE.parent / "build" / "perfbench" / "kernels")
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness import main, spec, window  # noqa: E402


def sweep(workload: str, rates: list[float], seconds: float, seed: int) -> list[dict]:
    cell = spec.load_cell(workload)
    out = []
    for rate in rates:
        cell.traffic = dict(cell.traffic, rate=rate)
        run, _, _ = main.serve(cell, seed, seconds, False, "cuda", time.perf_counter(),
                               build_dir=Path(os.environ["REPRO_TORCH_BUILD_DIR"]))
        tl = run.timeline
        due = [r for r, d in tl.due.items() if tl.t_open <= d < tl.t_close]
        started = [r for r in due if tl.token_t[r] and tl.token_t[r][0] <= tl.t_close]
        finished = [r for r in due if tl.done(r) and tl.token_t[r][-1] <= tl.t_close]
        ttft = window.ttft_ms(tl)
        out.append({"rate": rate, "due": len(due), "started": len(started),
                    "finished": len(finished), "waiting_at_close": len(due) - len(started),
                    "ttft_p50_ms": window.percentile(ttft, 50),
                    "ttft_p90_ms": window.percentile(ttft, 90),
                    "ttft_max_ms": max(ttft) if ttft else None,
                    "arrival_lag_p99_ms": window.percentile(window.arrival_lag_ms(tl), 99)})
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 77)
    args = ap.parse_args()
    sweep(args.workload, [float(r) for r in args.rates.split(",")], args.seconds, args.seed)
