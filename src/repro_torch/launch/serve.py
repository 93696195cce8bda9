"""Serving launcher: open-loop continuous batching of a ported arch
(``qwen1.5-0.5b``, ``mamba2-2.7b``, ``recurrentgemma-9b``).

Requests arrive by a Poisson process (``--arrival-rate`` req/s of wall
clock; 0 = everything at t=0), with ragged prompt lengths and per-request
decode budgets, and stream through ``repro_torch.serve.ServeEngine``.  Pass
``--accuracy`` to let the matmul planner pick the RMPM precision mode and
impl per phase — prefill and decode GEMMs are planned separately, so a
budget near a mode boundary flips the mode bits *between phases of the same
workload* (the paper's run-time reconfiguration, end to end).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 8 --slots 4 --accuracy 2e-4 [--kv-int8] [--device cpu --smoke]

The model runs on the GPU; ``--device cpu`` (with ``--smoke``) runs the plain
versions on the CPU.  Pass ``--adapt`` (with ``--slo-err``, optionally
``--slo-ms``) to close the loop at run time: the decode phase's modes become
a mutable mode table that the probe + hysteresis controller retunes against
the SLO between steps, with nothing rebuilt.  Pass ``--speculate`` (with
``--draft-k``, ``--draft-shift``) for self-speculative decoding
(repro_torch.spec): the cheap mode of the same step drafts, the exact step
verifies — identical outputs.  ``--tune-table`` plans ``--accuracy`` from a
measured tuning table (``python -m repro_torch.tune``).  ``--paged`` serves
from a page-table KV cache (``--page-size``, ``--pool-pages``, prefix
sharing unless ``--no-prefix-sharing``); ``--tier-levels 5,3`` adds
precision-tiered pages (``--tier-cold-after``, ``--tier-every``,
``--tier-budget``), demoted by the quantize_mantissa kernel.
``--multi-tenant`` serves a canned interactive-vs-bulk tenant mix; with
``--adapt`` each tenant gets its own mode table and controller.
``--trace`` records structured events (repro_torch.obs) and prints the
precision timeline; ``--trace-out PATH`` also writes a Chrome trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import PRESETS
from repro_torch.models import build_model
from repro_torch.plan import plan_cache_stats
from repro_torch.serve import Request, ServeConfig, ServeEngine, ragged_requests


def run_open_loop(eng: ServeEngine, reqs: list[Request], rate: float,
                  rng: np.random.Generator) -> dict[int, list[int]]:
    """Submit each request at its Poisson arrival time (wall clock), stepping
    the engine in between — requests join slots mid-flight as capacity
    frees."""
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=len(reqs)))
    else:
        arrivals = np.zeros(len(reqs))
    t0 = time.perf_counter()
    pending = list(zip(arrivals, reqs))
    outputs: dict[int, list[int]] = {}
    while pending or eng.scheduler.has_work():
        now = time.perf_counter() - t0
        while pending and pending[0][0] <= now:
            eng.submit(pending.pop(0)[1])
        if eng.scheduler.has_work():
            eng.step()
        elif pending:
            time.sleep(min(pending[0][0] - now, 0.05))
    for rid, toks in eng.drain().items():
        outputs[rid] = toks
    return outputs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises when there "
                         "is none). 'cpu' runs the plain versions")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0,
                    help="slot-array width (0 = one per request)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12,
                    help="max prompt length; actual lengths are ragged")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival rate in req/s (0 = all at t=0)")
    ap.add_argument("--policy", default="native_f32", choices=tuple(PRESETS))
    ap.add_argument("--impl", default=None,
                    choices=("xla", "pallas", "tile", "native", "auto"),
                    help="override the preset's impl ('pallas' = the limb kernel)")
    ap.add_argument("--accuracy", type=float, default=None,
                    help="plan per-phase precision for this relative-error "
                         "budget instead of using the --policy preset modes")
    ap.add_argument("--tune-table", default="",
                    help="measured-cost tuning table (file or directory, "
                         "repro_torch.tune) for the per-phase planner; empty = "
                         "TUNE_TABLE env var, then pure roofline")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--adapt", action="store_true",
                    help="closed-loop runtime precision adaptation of the "
                         "decode phase (repro_torch.adapt)")
    ap.add_argument("--slo-err", type=float, default=0.05,
                    help="SLO: max observed relative error (probe logit "
                         "residual vs the max-mode reference)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="SLO: decode-step latency target in ms (0 = none)")
    ap.add_argument("--adapt-every", type=int, default=4,
                    help="probe cadence in decode steps")
    ap.add_argument("--speculate", action="store_true",
                    help="self-speculative decoding (repro_torch.spec): draft "
                         "--draft-k tokens per slot under a cheap mode "
                         "table, verify with the exact baseline step — "
                         "identical outputs")
    ap.add_argument("--draft-k", type=int, default=3,
                    help="draft depth per speculative round")
    ap.add_argument("--draft-shift", type=int, default=2,
                    help="initial rungs below the verify modes for the "
                         "draft table (the acceptance controller retunes "
                         "it at run time)")
    ap.add_argument("--multi-tenant", action="store_true",
                    help="canned interactive-vs-bulk tenant mix under the "
                         "priority scheduler, with a per-tenant SLO report")
    ap.add_argument("--scheduler-policy", default="priority",
                    choices=("priority", "fifo"),
                    help="scheduler for --multi-tenant (default: priority)")
    ap.add_argument("--paged", action="store_true",
                    help="page-table KV cache with prefix sharing "
                         "(repro_torch.serve.paged)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=0)
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--tier-levels", default="",
                    help="precision-tiered pages (with --paged): keep-bits "
                         "ladder, shallowest first, e.g. 5,3")
    ap.add_argument("--tier-cold-after", type=int, default=32)
    ap.add_argument("--tier-every", type=int, default=8)
    ap.add_argument("--tier-budget", type=float, default=0.0)
    ap.add_argument("--trace", action="store_true",
                    help="record structured trace events (repro_torch.obs)")
    ap.add_argument("--trace-out", default="",
                    help="write the trace as Chrome-trace/Perfetto JSON to "
                         "this path (implies --trace)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    policy = PRESETS[args.policy]
    if args.impl is not None:
        policy = policy.with_impl(args.impl)
    cfg = cfg.with_policy(policy)
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("use examples/ for multimodal drivers on CPU")
    model = build_model(cfg, device=args.device)  # None -> the GPU, or raise
    params = model.init(args.seed)

    rng = np.random.default_rng(args.seed)
    tenants = None
    classes = None
    if args.multi_tenant:
        from repro_torch.serve import RequestClass, Tenant, class_requests

        tenants = [Tenant("interactive", priority=0, share=2.0),
                   Tenant("bulk", priority=2, share=1.0)]
        classes = [RequestClass("chat", slo_steps=10, prompt_len=6,
                                max_new=max(args.max_new // 2, 2)),
                   RequestClass("batch", prompt_len=args.prompt_len,
                                max_new=args.max_new)]
        n_bulk = max(args.requests // 2, 1)
        reqs = class_requests(classes[1], tenants[1], n_bulk, cfg.vocab, rng)
        reqs += class_requests(classes[0], tenants[0],
                               max(args.requests - n_bulk, 1), cfg.vocab,
                               rng, rid_base=100)
    else:
        reqs = ragged_requests(args.requests, cfg.vocab, args.prompt_len,
                               args.max_new, rng)
    eng = ServeEngine(
        model, params,
        config=ServeConfig.from_flags(args, tenants=tenants, classes=classes))
    t0 = time.perf_counter()
    outs = run_open_loop(eng, reqs, args.arrival_rate, rng)
    dt = time.perf_counter() - t0
    for rid in sorted(outs):
        print(f"req {rid}: {outs[rid]}")
    print(eng.format_describe())
    if args.adapt or args.speculate:
        print(f"kernel library builds: {eng.kernel_build_count}")
    print(f"CUDA graphs captured: {eng.graph_capture_count}")
    stats = plan_cache_stats()
    print(f"plan cache: {stats.entries} entries, "
          f"{stats.hits} hits / {stats.misses} misses (process-wide)")
    total = sum(len(v) for v in outs.values())
    print(f"{total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s on {model.device}; "
          f"kv={cfg.kv_cache_dtype}; slots={eng.config.batch_slots})")
    print(eng.metrics.format_summary())
    if eng.tracer.enabled:
        print(f"precision timeline:\n{eng.tracer.format_timeline()}")
        if args.trace_out:
            doc = eng.tracer.export_chrome(args.trace_out)
            print(f"trace: {len(doc['traceEvents'])} Chrome events "
                  f"-> {args.trace_out}")


if __name__ == "__main__":
    main()
