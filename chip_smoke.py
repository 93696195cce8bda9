#!/usr/bin/env python3
"""chip_smoke.py — drive the PyTorch/CUDA port end to end on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the three CUDA kernels from ``src/repro_torch/csrc`` (once), holds
each against its plain PyTorch version on the card at the shapes the serving
path gives it, times them beside their bound, then serves ``qwen1.5-0.5b`` at
full width (seed-made weights) through ``repro_torch.serve.ServeEngine`` in
four configurations and checks what comes out.  Every phase prints one JSON
line; any failed phase ends the run with a non-zero exit code.  There is no
CPU mode: without a GPU the script raises before it prints any result.

``--phases a,b`` runs a subset (for a first build check); ``--layers N`` cuts
the depth of the full-width model (widths are never cut).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch.adapt import SLO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Mode, PrecisionPolicy  # noqa: E402
from repro_torch.core.limb import limb_product_terms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.limb_matmul.ops import limb_matmul, limb_matmul_plain, tile_grid  # noqa: E402
from repro_torch.kernels.quantize_mantissa.ops import (  # noqa: E402
    quantize_mantissa_op,
    quantize_mantissa_plain,
)
from repro_torch.kernels.tile_matmul.ops import (  # noqa: E402
    tile_matmul,
    tile_matmul_mode,
    tile_matmul_plain,
    tile_matmul_runtime,
)
from repro_torch.launch.serve import run_open_loop  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.plan import F32_FLOPS, HBM_BW, PEAK_FLOPS  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdaptConfig,
    Request,
    ServeConfig,
    ServeEngine,
    ragged_requests,
)

ARCH = "qwen1.5-0.5b"
#: (K, N) of the weight GEMMs on the serving path: wq/wk/wv/wo, gate/up, down
MAIN_KN = ((1024, 1024), (1024, 2816), (2816, 1024))
#: M of the decode step (slots) and of a prefill (longest prompt)
MAIN_M = (4, 48)
#: matmul kernels vs their plain versions: max-abs error over result scale
#: (the bound the reference holds its own kernels to)
MATMUL_TOL = 2e-6
PHASES = ("device", "kernels", "serve_static", "serve_adapt", "serve_grte",
          "serve_planned")

KERNEL_INFO = {
    "quantize_mantissa": dict(
        route="cuda", source="src/repro_torch/csrc/quantize_mantissa.cu",
        replaces="src/repro/kernels/quantize_mantissa/quantize_mantissa.py:56"),
    "limb_matmul": dict(
        route="cuda", source="src/repro_torch/csrc/limb_matmul.cu",
        replaces="src/repro/kernels/limb_matmul/limb_matmul.py:165"),
    "tile_matmul": dict(
        route="cuda", source="src/repro_torch/csrc/tile_matmul.cu",
        replaces="src/repro/kernels/tile_matmul/tile_matmul.py:82"),
}


#: file that also receives every JSON line (``--out``); the terminal of a
#: remote run may keep only the end of the output
_OUT_PATH: str | None = None


def say(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _OUT_PATH:
        with open(_OUT_PATH, "a") as fh:
            fh.write(line + "\n")


def emit(phase: str, **payload) -> None:
    say({"phase": phase, **payload})


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


_HEAD_START: dict = {}


def _head_start() -> None:
    """Keep the card busy for a few milliseconds (one 4096^3 f32 product), so
    that the launches timed after it are all queued before the first of them
    starts: the events then bracket device time, not the host's launch rate."""
    if not _HEAD_START:
        x = torch.randn((4096, 4096), device="cuda")
        _HEAD_START.update(x=x, out=torch.empty_like(x))
    torch.matmul(_HEAD_START["x"], _HEAD_START["x"], out=_HEAD_START["out"])


def time_ms(fn, n_variants: int = 1, warmup: int = 3, reps: int = 10,
            samples: int = 5) -> tuple[float, float]:
    """``(device_ms, enqueue_ms)`` of one ``fn(i)`` call.  ``device_ms``: CUDA
    events around ``reps`` calls queued behind a head start (see above), median
    over ``samples`` such runs.  ``enqueue_ms``: the host's time to enqueue one
    call (wrapper, checks, allocation, launch), which is what a caller pays
    when the card is faster than the host.  ``fn`` is called with a rotating
    index below ``n_variants`` so a caller can cycle operand copies larger
    than the L2 cache, as the serving path (2.5 GB of weights per step) finds
    them: cold.  A plain version made of many small operations cannot be
    queued ahead of the card; its ``device_ms`` then is its enqueue time."""
    for i in range(warmup):
        fn(i % n_variants)
    torch.cuda.synchronize()
    times, enqueues = [], []
    call = 0
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _head_start()
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(call % n_variants)
            call += 1
        enqueues.append((time.perf_counter() - t0) * 1e3 / reps)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), statistics.median(enqueues)


def n_rotations(nbytes: int) -> int:
    """Copies of an operand needed to exceed the 50 MB L2 between reuses."""
    return max(2, math.ceil(64e6 / max(nbytes, 1)) + 1)


def gemm_bound_ms(m: int, k: int, n: int, passes: float) -> tuple[float, str]:
    """Least time for the GEMM on the data-sheet card: bytes (each operand
    read once, the result written once) over the memory rate, or the
    retained passes' operations over the bf16 tensor-core rate."""
    t_bytes = 4.0 * (m * k + k * n + m * n) / HBM_BW
    t_ops = passes * 2.0 * m * k * n / PEAK_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = out.splitlines()[0].strip()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)


def _errs(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max-abs error, the same over the result's scale)."""
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / float(want.abs().max().clamp_min(1e-30))


def _mixed_map(grid, gen_cpu, kmax=3):
    return torch.randint(1, kmax + 1, grid, generator=gen_cpu, dtype=torch.int32).cuda()


def check_kernels(gen) -> dict:
    """Hold every kernel against its plain version on the card."""
    gen_cpu = torch.Generator().manual_seed(7)
    worst = {"quantize_mantissa": 0.0, "limb_matmul": 0.0, "tile_matmul": 0.0}
    worst_abs = dict(worst)
    n_cases = 0
    shapes = [(m, k, n) for m in MAIN_M for (k, n) in MAIN_KN] + [(17, 33, 9)]
    # quantize: bit-exact, three roundings x keep {7, 15}, with specials
    for shape in ((4, 1024), (48, 2816), (1024, 2816), (17, 33)):
        x = _rand(gen, *shape)
        x.view(-1)[:6] = torch.tensor(
            [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-41], device="cuda")
        for rounding in ("grte", "trunc", "rne"):
            for keep in (7, 15):
                got = quantize_mantissa_op(x, keep, rounding)
                want = quantize_mantissa_plain(x, keep, rounding)
                torch.cuda.synchronize()
                same = torch.equal(got.view(torch.int32), want.view(torch.int32))
                check(same, f"quantize_mantissa {shape} {rounding} keep={keep} not bit-exact")
                n_cases += 1
    for m, k, n in shapes:
        a, b = _rand(gen, m, k), _rand(gen, k, n)
        grid, (bm, bn, bk) = tile_grid(m, n, k)
        for limbs in (1, 2, 3):
            got = limb_matmul(a, b, limbs)
            torch.cuda.synchronize()
            want = limb_matmul_plain(a, b, limbs, bk=bk)
            abs_err, err = _errs(got, want)
            worst["limb_matmul"] = max(worst["limb_matmul"], err)
            worst_abs["limb_matmul"] = max(worst_abs["limb_matmul"], abs_err)
            check(err <= MATMUL_TOL, f"limb_matmul {(m, k, n)} k={limbs}: {err:.3e} > {MATMUL_TOL}")
            # uniform map == limb kernel, and runtime == static: bitwise
            uni = tile_matmul_mode(a, b, Mode(limbs))
            rt_host = tile_matmul_runtime(a, b, limbs)
            rt_dev = tile_matmul_runtime(a, b, torch.tensor(limbs, dtype=torch.int32, device="cuda"))
            torch.cuda.synchronize()
            check(torch.equal(uni, got), f"uniform map != limb kernel at {(m, k, n)} k={limbs}")
            check(torch.equal(rt_host, uni), f"runtime(host int) != static at {(m, k, n)} mode={limbs}")
            check(torch.equal(rt_dev, uni), f"runtime(device scalar) != static at {(m, k, n)} mode={limbs}")
            n_cases += 4
        # mixed maps, 2-D and 3-D, against the plain version
        for shape in (grid[:2], grid):
            mode_map = _mixed_map(shape, gen_cpu)
            got = tile_matmul(a, b, mode_map)
            torch.cuda.synchronize()
            want = tile_matmul_plain(a, b, mode_map, kmax=3, bm=bm, bn=bn, bk=bk)
            abs_err, err = _errs(got, want)
            worst["tile_matmul"] = max(worst["tile_matmul"], err)
            worst_abs["tile_matmul"] = max(worst_abs["tile_matmul"], abs_err)
            check(err <= MATMUL_TOL, f"tile_matmul {(m, k, n)} map{tuple(shape)}: {err:.3e}")
            n_cases += 1
    # a finer map grid than the default, so one launch holds many map tiles
    a, b = _rand(gen, 48, 1024), _rand(gen, 1024, 1024)
    grid, (bm, bn, bk) = tile_grid(48, 1024, 1024, bm=16, bn=64, bk=128)
    mode_map = _mixed_map(grid, gen_cpu)
    got = tile_matmul(a, b, mode_map, bm=16, bn=64, bk=128)
    want = tile_matmul_plain(a, b, mode_map, kmax=3, bm=bm, bn=bn, bk=bk)
    abs_err, err = _errs(got, want)
    worst["tile_matmul"] = max(worst["tile_matmul"], err)
    worst_abs["tile_matmul"] = max(worst_abs["tile_matmul"], abs_err)
    check(err <= MATMUL_TOL, f"tile_matmul fine 3-D map: {err:.3e}")
    # ladder: error against f64 falls strictly k = 1 > 2 > 3
    a, b = _rand(gen, 48, 1024), _rand(gen, 1024, 2816)
    exact = a.double() @ b.double()
    ladder = [float((limb_matmul(a, b, kk).double() - exact).abs().max() / exact.abs().max())
              for kk in (1, 2, 3)]
    check(ladder[0] > ladder[1] > ladder[2], f"ladder not falling: {ladder}")
    # grte pre-pass composes the same way in both matmul wrappers
    check(torch.equal(limb_matmul(a, b, 2, rounding="grte"),
                      tile_matmul_mode(a, b, Mode.M16, rounding="grte")),
          "grte: uniform map != limb kernel")
    return {"cases": n_cases + 4, "max_rel_err": worst, "max_abs_err": worst_abs,
            "ladder_rel_err": ladder}


def time_kernels(gen) -> dict:
    """Time every kernel at the serving path's shapes beside its bound, its
    plain version and the library's matmul at the same shape."""
    rows = []
    for m in MAIN_M:
        for (k, n) in MAIN_KN:
            a = _rand(gen, m, k)
            n_rot = n_rotations(4 * k * n)
            bs = [_rand(gen, k, n) for _ in range(n_rot)]
            bs16 = [x.to(torch.bfloat16) for x in bs]
            a16 = a.to(torch.bfloat16)
            grid, (bm, bn, bk) = tile_grid(m, n, k)
            lib32, _ = time_ms(lambda i: torch.matmul(a, bs[i]), n_rot)
            lib16, _ = time_ms(lambda i: torch.matmul(a16, bs16[i]), n_rot)
            for limbs in (2, 3):
                passes = len(limb_product_terms(limbs))
                bound, by = gemm_bound_ms(m, k, n, passes)
                common = dict(m=m, k=k, n=n, limbs=limbs, bound_ms=bound, bound_by=by,
                              library_ms=lib32, library_bf16_ms=lib16)
                uniform = torch.full(grid[:2], limbs, dtype=torch.int32, device="cuda")
                ms, enqueue = time_ms(lambda i: limb_matmul(a, bs[i], limbs), n_rot)
                plain, _ = time_ms(lambda i: limb_matmul_plain(a, bs[i], limbs, bk=bk), n_rot)
                rows.append(dict(kernel="limb_matmul", ms=ms, enqueue_ms=enqueue,
                                 plain_ms=plain, **common))
                ms, enqueue = time_ms(lambda i: tile_matmul_runtime(a, bs[i], limbs), n_rot)
                plain, _ = time_ms(
                    lambda i: tile_matmul_plain(a, bs[i], uniform, kmax=3, bm=bm, bn=bn, bk=bk),
                    n_rot)
                rows.append(dict(kernel="tile_matmul", ms=ms, enqueue_ms=enqueue,
                                 plain_ms=plain, **common))
            del bs, bs16
    # quantize pre-pass shapes: the activation and the weight of a site
    for shape in ((4, 1024), (1024, 2816)):
        nbytes = 4 * shape[0] * shape[1]
        n_rot = n_rotations(nbytes)
        xs = [_rand(gen, *shape) for _ in range(n_rot)]
        ms, enqueue = time_ms(lambda i: quantize_mantissa_op(xs[i], 15, "grte"), n_rot)
        plain, _ = time_ms(lambda i: quantize_mantissa_plain(xs[i], 15, "grte"), n_rot)
        rows.append(dict(
            kernel="quantize_mantissa", m=shape[0], k=None, n=shape[1], limbs=None,
            ms=ms, enqueue_ms=enqueue, plain_ms=plain,
            bound_ms=2.0 * nbytes / HBM_BW * 1e3, bound_by="bytes",
            library_ms=None, library_bf16_ms=None))
        del xs
    # the f32 rate 'native' is charged at, beside a measured f32 matmul
    big = 4096
    x, y = _rand(gen, big, big), _rand(gen, big, big)
    f32_ms, _ = time_ms(lambda i: torch.matmul(x, y))
    f32_rate = 2.0 * big**3 / (f32_ms * 1e-3)
    return {"rows": rows,
            "f32_matmul_4096": {"ms": f32_ms, "flop_per_s": f32_rate,
                                "datasheet_flop_per_s": F32_FLOPS}}


def phase_kernels(gen) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    build.library(verbose=True)
    build_s = time.perf_counter() - t0
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1")
    checks = check_kernels(gen)
    timing = time_kernels(gen)
    check(build.BUILD_COUNT == 1, "kernels were built more than once")
    emit("kernels", build_s=build_s, build_count=build.BUILD_COUNT,
         kernels=sorted(KERNEL_INFO), tolerance=MATMUL_TOL, **checks,
         kernel_ms=timing["rows"], f32_matmul_4096=timing["f32_matmul_4096"])
    return checks, timing


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------


def full_width_model(policy: PrecisionPolicy, n_layers: int | None = None):
    cfg = get_config(ARCH).with_policy(policy)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return build_model(cfg)  # device=None: the GPU, or raise


def serve(model, params, config: ServeConfig, reqs: list[Request], seed: int):
    """Serve ``reqs`` through run_open_loop with the launch counts zeroed
    just before and read just after.  Returns (engine, outputs, counts, s)."""
    eng = ServeEngine(model, params, config=config)
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = run_open_loop(eng, reqs, 0.0, rng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    for r in reqs:
        check(r.rid in outs, f"request {r.rid} did not complete")
        budget = eng.scheduler.tickets[r.rid].budget
        check(len(outs[r.rid]) == budget,
              f"request {r.rid}: {len(outs[r.rid])} tokens, budget {budget}")
        check(all(0 <= t < model.cfg.vocab for t in outs[r.rid]),
              f"request {r.rid}: token out of range")
    return eng, outs, counts, wall


def solo_tokens(model, params, req: Request, max_len: int) -> list[int]:
    """The port's own solo decode of one request: a 1-slot engine."""
    eng = ServeEngine(model, params, config=ServeConfig(batch_slots=1, max_len=max_len))
    return eng.generate_batch([Request(req.prompt, req.max_new, rid=req.rid)])[req.rid]


def serve_summary(eng, outs, wall) -> dict:
    s = eng.metrics.summary()
    total = sum(len(v) for v in outs.values())
    return {"requests": len(outs), "tokens": total, "wall_s": wall,
            "tok_per_s": total / wall, "ttft_s_mean": s.get("ttft_mean_s"),
            "ttft_s_max": max(eng.metrics.ttft(rid) for rid in outs),
            "decode_steps": s.get("decode_steps"),
            "occupancy": s.get("occupancy"),
            "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def step_breakdown(model, params, slots: int = 4, prompt_len: int = 48,
                   max_len: int = 96) -> dict:
    """Where one decode step and one prefill spend their time: wall time of
    each (host clock around a synchronised call, median of 5), the logits
    site alone (the limb algebra over the vocabulary), kernel launches per
    call, and the share of a decode step's wall time in which the card was
    busy (sum of device kernel times from ``torch.profiler`` over the wall)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    vocab, d = model.cfg.vocab, model.cfg.d_model

    def wall_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    prompt = torch.randint(0, vocab, (1, prompt_len), generator=gen, device="cuda")
    solo0 = model.init_decode_state(1, max_len, per_slot=True)
    prompts = torch.randint(0, vocab, (slots, prompt_len // 2), generator=gen, device="cuda")
    _, state = model.decode_step(params, prompts,
                                 model.init_decode_state(slots, max_len, per_slot=True))
    tok = torch.randint(0, vocab, (slots, 1), generator=gen, device="cuda")
    x_dec = torch.randn((slots, 1, d), generator=gen, device="cuda")
    x_pre = torch.randn((1, prompt_len, d), generator=gen, device="cuda")

    before = build.launch_counts()
    model.decode_step(params, tok, state)
    mid = build.launch_counts()
    model.decode_step(params, prompt, solo0)
    after = build.launch_counts()
    out = {
        "slots": slots, "prompt_len": prompt_len, "cache_len": prompt_len // 2,
        "decode_step_ms": wall_ms(lambda: model.decode_step(params, tok, state)),
        "decode_logits_ms": wall_ms(lambda: model._logits(params, x_dec)),
        "prefill_ms": wall_ms(lambda: model.decode_step(params, prompt, solo0)),
        "prefill_logits_ms": wall_ms(lambda: model._logits(params, x_pre)),
        "launches_per_decode_step": {k: mid[k] - before[k] for k in mid},
        "launches_per_prefill": {k: after[k] - mid[k] for k in mid},
    }
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, tok, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:6]
    out["profiled_decode_steps"] = steps
    out["device_busy_share_under_profiler"] = (busy_us / wall_us) if busy_us else None
    out["device_ms_per_decode_step"] = (busy_us / steps / 1e3) if busy_us else None
    out["top_device_kernels"] = [
        {"name": e.key[:60], "calls_per_step": e.count / steps,
         "device_ms_per_step": e.device_time_total / steps / 1e3} for e in top]
    return out


def phase_serve_static(params_cache, n_layers):
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    model = full_width_model(policy, n_layers)
    params = params_cache(model)
    reqs = ragged_requests(8, model.cfg.vocab, 48, 16, np.random.default_rng(0))
    cfg = ServeConfig(batch_slots=4, max_len=96)
    eng, outs, counts, wall = serve(model, params, cfg, reqs, seed=0)
    check(counts["limb_matmul"] > 0, "serve_static launched the limb kernel no time")
    check(counts["tile_matmul"] == 0, "static policy reached the mode-map kernel")
    solo_ok = []
    for r in reqs[:2]:
        solo = solo_tokens(model, params, r, 96)
        check(solo == outs[r.rid], f"request {r.rid}: batched tokens != solo decode")
        solo_ok.append(r.rid)
    # one decode step's logits against the plain limb algebra ('xla') on the
    # same weights: the kernels and the plain version serve the same model
    ref_model = model.with_policy(PrecisionPolicy(default=Mode.M16, impl="xla"))
    toks = torch.as_tensor(np.asarray(reqs[0].prompt)[None, :], device="cuda")
    l_kernel, _ = model.decode_step(params, toks, model.init_decode_state(1, 96, per_slot=True))
    l_plain, _ = ref_model.decode_step(params, toks, ref_model.init_decode_state(1, 96, per_slot=True))
    check(bool(torch.isfinite(l_kernel).all()), "non-finite logits")
    check(tuple(l_kernel.shape) == (1, len(reqs[0].prompt), model.cfg.vocab), "logits shape")
    gap = float((l_kernel - l_plain).abs().max() / l_plain.std())
    check(gap < 1e-3, f"kernel-path logits differ from the plain limb algebra: {gap:.3e} of spread")
    emit("serve_static", arch=ARCH, layers=model.cfg.n_layers, d_model=model.cfg.d_model,
         vocab=model.cfg.vocab, policy=policy.describe(), launches=counts,
         solo_equal_rids=solo_ok, logits_gap_vs_plain_over_spread=gap,
         build_count=build.BUILD_COUNT, **serve_summary(eng, outs, wall),
         breakdown=step_breakdown(model, params))
    return counts


def phase_serve_adapt(params_cache, n_layers):
    policy = PrecisionPolicy(default=Mode.M24, impl="pallas")
    model = full_width_model(policy, n_layers)
    params = params_cache(model)
    reqs = ragged_requests(4, model.cfg.vocab, 48, 16, np.random.default_rng(1))
    cfg = ServeConfig(batch_slots=4, max_len=96,
                      adapt=AdaptConfig(slo=SLO(max_err=0.05), adapt_every=2))
    eng = ServeEngine(model, params, config=cfg)
    # prefill runs unbound (limb kernel); decode runs bound (mode-map kernel)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    limb_after_prefill = None
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    while eng.scheduler.has_work():
        before = build.launch_counts()
        n_wait = eng.scheduler.n_waiting
        eng.step()
        after = build.launch_counts()
        if n_wait == 0:  # a pure decode step: no admission, so no prefill
            check(after["limb_matmul"] == before["limb_matmul"],
                  "limb kernel launched during a bound decode step")
            limb_after_prefill = after["limb_matmul"]
    outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    for r in reqs:
        check(len(outs[r.rid]) == eng.scheduler.tickets[r.rid].budget,
              f"request {r.rid} incomplete")
    check(counts["tile_matmul"] > 0, "serve_adapt launched the mode-map kernel no time")
    check(limb_after_prefill is not None, "no pure decode step ran")
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1 after mode shifts")
    check(len(eng.controller.history) > 0, "no probe ran")
    emit("serve_adapt", policy=policy.describe(), launches=counts,
         build_count=build.BUILD_COUNT, probes=len(eng.controller.history),
         mode_switches=eng.mode_table.switches,
         mode_timeline=[[int(s), lab] for s, lab in eng.metrics.mode_timeline],
         adaptation=eng.describe_adaptation(), **serve_summary(eng, outs, wall))
    return counts


def phase_serve_grte(params_cache, n_layers):
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas", rounding="grte")
    model = full_width_model(policy, min(4, n_layers or 4))
    params = params_cache(model)
    reqs = ragged_requests(2, model.cfg.vocab, 48, 16, np.random.default_rng(2))
    cfg = ServeConfig(batch_slots=2, max_len=96)
    eng, outs, counts, wall = serve(model, params, cfg, reqs, seed=2)
    check(counts["quantize_mantissa"] > 0, "serve_grte launched the quantize kernel no time")
    check(counts["limb_matmul"] > 0, "serve_grte launched the limb kernel no time")
    emit("serve_grte", policy=policy.describe(), layers=model.cfg.n_layers,
         launches=counts, build_count=build.BUILD_COUNT,
         **serve_summary(eng, outs, wall))
    return counts


def phase_serve_planned(params_cache, n_layers):
    model = full_width_model(PrecisionPolicy(default=Mode.M24, impl="auto"), n_layers)
    params = params_cache(model)
    reqs = ragged_requests(4, model.cfg.vocab, 48, 16, np.random.default_rng(3))
    cfg = ServeConfig(batch_slots=4, max_len=96, accuracy=2.0**-12)
    eng, outs, counts, wall = serve(model, params, cfg, reqs, seed=3)
    emit("serve_planned", accuracy=2.0**-12, plans=eng.describe_plans().splitlines(),
         launches=counts, build_count=build.BUILD_COUNT,
         **serve_summary(eng, outs, wall))
    return counts


# ---------------------------------------------------------------------------
# the kernels line
# ---------------------------------------------------------------------------


def kernels_line(checks, timing, main_counts) -> dict:
    """One entry per kernel: its numbers at the decode shape that dominates
    the serving path (every measured shape is in the ``kernels`` phase line)."""
    primary = {"limb_matmul": (4, 1024, 2816, 2), "tile_matmul": (4, 1024, 2816, 3),
               "quantize_mantissa": (1024, None, 2816, None)}
    out = []
    for name, info in KERNEL_INFO.items():
        rows = [r for r in timing["rows"] if r["kernel"] == name]
        m, k, n, limbs = primary[name]
        main = next(r for r in rows if (r["m"], r["k"], r["n"], r["limbs"]) == (m, k, n, limbs))
        out.append(dict(
            name=name, **info, launches=main_counts[name],
            max_abs_err=checks["max_abs_err"][name],
            max_rel_err=checks["max_rel_err"][name],
            err_is="largest |kernel - plain| over all checked cases (N(0,1) operands); "
                   "max_rel_err is that over the result's scale, held to 2e-6"
                   if name != "quantize_mantissa" else "bit-exact (0 differing words)",
            shape={"m": m, "k": k, "n": n, "limbs": limbs},
            ms=main["ms"], enqueue_ms=main["enqueue_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"]))
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth (widths stay full)")
    ap.add_argument("--out", default=None,
                    help="also append every JSON line to this file")
    args = ap.parse_args()
    global _OUT_PATH
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        _OUT_PATH = args.out
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            raise SystemExit(f"unknown phase {p!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = phase_device()

    cache: dict = {}

    def params_cache(model):
        """Seed-made weights, shared by phases of the same depth."""
        key = model.cfg.n_layers
        if key not in cache:
            cache.clear()
            cache[key] = model.init(0)
        return cache[key]

    checks = timing = None
    if "kernels" in phases:
        checks, timing = phase_kernels(gen)
    main_counts = {name: 0 for name in KERNEL_INFO}
    for name, fn in (("serve_static", phase_serve_static),
                     ("serve_adapt", phase_serve_adapt),
                     ("serve_grte", phase_serve_grte)):
        if name in phases:
            for kname, c in fn(params_cache, args.layers).items():
                main_counts[kname] += c
    if "serve_planned" in phases:
        phase_serve_planned(params_cache, args.layers)
    full = all(p in phases for p in PHASES)
    if full:
        for name, c in main_counts.items():
            check(c > 0, f"kernel {name} was launched no time on the serving path")
        check(build.BUILD_COUNT == 1, "the kernel library was built more than once")
    if checks is not None:
        say(kernels_line(checks, timing, main_counts))
    say({"card": card, "wall_s": time.perf_counter() - t_start,
         "phases": phases, "build_count": build.BUILD_COUNT})
    print(card, flush=True)
    say({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
