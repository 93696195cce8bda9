#!/usr/bin/env python3
"""gemm_ab.py — time the limb, mode-map and double-f32 kernels, two captured
decode steps and two eager prefills of two checkouts on one GPU, in turns.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc,
with an earlier tree unpacked beside it (``git archive <commit> | tar -x -C
build/parent``):

    python3 tools/gemm_ab.py --parent build/parent --out build/gemm_ab.jsonl

Each arm runs in its own process with its own tree first on ``PYTHONPATH``
and its own build directory, in the order parent, change, change, parent
(the change is the checkout holding this file).  An arm builds its kernels
and times, with its own ``chip_smoke.py``'s ``time_ms`` (CUDA events around
calls queued behind a head start, operands rotated past the L2 cache):

  kernels   the limb kernel and the mode-map kernel (``tile_matmul`` with
            the uniform map built beforehand) at k = 2 and 3, at every
            (M, K, N) of ``chip_smoke.py``'s ``MAIN_KN``, ``HYBRID_KN`` and
            ``FAMILY_SHAPES`` with M <= 16, at M = 48 over ``MAIN_KN`` and
            ``HYBRID_KN``, and at every M > 16 row of ``FAMILY_SHAPES`` (M =
            23, 48, 264, 279, 1500); the double-f32 kernel at M = 4 and 48
            over ``MAIN_KN`` at 4 and 6 limbs; one f32 ``torch.matmul`` per
            shape;
  steps     the captured decode step of ``qwen1.5-0.5b`` at full width and
            depth and of ``recurrentgemma-9b`` at full width cut to one
            (rec, rec, attn_local) supergroup (M16 ``pallas``, 4 slots, 24
            cached tokens): replay device ms by CUDA events, kernel ms per
            step and the limb and map kernels' share from ``torch.profiler``;
  prefills  two eager calls through the model's entry points at full width
            and depth, M16 ``pallas``, timed by CUDA events: Whisper's
            ``prefill_encoder`` over 1,500 frames (``whisper-medium``) and a
            48-token prefill of ``qwen1.5-0.5b`` (``decode_step`` on a fresh
            state), with the kernel launches of one call.

Each arm prints one JSON line; the last line sets every timed row beside the
median of the parent's two runs and of the change's two, their ratio and,
for the kernels, the share of the bound; it counts the rows of each body
(``path``: the change's) that are faster than the parent in both change
runs, and the largest change of the others.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "change", "change", "parent")


def _worker(tree: str, tasks: list[str]) -> dict:
    import repro_torch  # the arm's tree, first on PYTHONPATH

    if not os.path.abspath(repro_torch.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, not {tree}")
    sys.path.insert(1, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import Mode, PrecisionPolicy
    from repro_torch.core.limb import limb_product_terms
    from repro_torch.kernels import build
    from repro_torch.kernels.limb_matmul import ops as limb_ops
    from repro_torch.kernels.limb_matmul.ops import limb_matmul, limb_matmul_dd, tile_grid
    from repro_torch.kernels.tile_matmul.ops import tile_matmul
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    body = getattr(limb_ops, "gemm_body", lambda m, k: "wide")
    out: dict = {"rows": [], "steps": {}, "prefills": {}}

    def timed_gemm(m, k, n, kernels):
        a = cs._rand(gen, m, k)
        n_rot = cs.n_rotations(4 * k * n)
        bs = [cs._rand(gen, k, n) for _ in range(n_rot)]
        grid, _ = tile_grid(m, n, k)
        lib, _ = cs.time_ms(lambda i: torch.matmul(a, bs[i]), n_rot)
        for name, limbs in kernels:
            if name == "limb_matmul_dd":
                fn = lambda i: limb_matmul_dd(a, bs[i], limbs)  # noqa: E731
                outputs, path = 2, "wide"
            elif name == "limb_matmul":
                fn = lambda i: limb_matmul(a, bs[i], limbs)  # noqa: E731
                outputs, path = 1, body(m, limbs)
            else:
                uniform = torch.full(grid[:2], limbs, dtype=torch.int32, device="cuda")
                fn = lambda i: tile_matmul(a, bs[i], uniform)  # noqa: E731
                outputs, path = 1, body(m, 3)
            ms, _ = cs.time_ms(fn, n_rot)
            bound, by = cs.gemm_bound_ms(m, k, n, len(limb_product_terms(limbs)), outputs)
            out["rows"].append(dict(kernel=name, m=m, k=k, n=n, limbs=limbs, path=path, ms=ms,
                                    bound_ms=bound, bound_by=by, library_f32_ms=lib))
        del bs

    if "kernels" in tasks:
        skinny = sorted({(m, k, n) for m_rows, kn in cs.FAMILY_SHAPES.values()
                         for m in m_rows if m <= 16 for (k, n) in kn}
                        | {(4, k, n) for (k, n) in cs.MAIN_KN + cs.HYBRID_KN})
        wide = sorted({(m, k, n) for m_rows, kn in cs.FAMILY_SHAPES.values()
                       for m in m_rows if m > 16 for (k, n) in kn}
                      | {(48, k, n) for (k, n) in cs.MAIN_KN + cs.HYBRID_KN})
        pairs = [(name, limbs) for limbs in (2, 3) for name in ("limb_matmul", "tile_matmul")]
        for m, k, n in skinny + wide:
            timed_gemm(m, k, n, pairs)
        for m in (4, 48):
            for k, n in cs.MAIN_KN:
                timed_gemm(m, k, n, [("limb_matmul_dd", 4), ("limb_matmul_dd", 6)])
    if "steps" in tasks:
        policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
        for arch, layers in ((cs.ARCH, None), (cs.HYBRID_ARCH, 3)):
            model = cs.full_width_model(policy, layers, arch=arch)
            params = model.init(0)
            eng = ServeEngine(model, params, config=ServeConfig(batch_slots=4, max_len=96))
            rng = np.random.default_rng(11)
            for i in range(4):
                eng.submit(Request(rng.integers(0, model.cfg.vocab, 24).astype(np.int32), 96,
                                   rid=i))
            eng.step()  # prefill every slot, then warm up and capture the decode step
            step = eng._step_graph
            replay = [cs.replay_event_ms(step) for _ in range(3)]
            prof = cs.device_busy(step, 5)
            gemm = [e for e in prof["events"]
                    if any(x in e.key for x in ("limb_matmul", "tile_matmul", "splitk_reduce"))]
            out["steps"][arch] = dict(
                layers=model.cfg.n_layers, replay_event_ms=replay,
                kernel_ms_per_step=prof["device_ms"],
                gemm_kernels={e.key[:90]: dict(calls_per_step=e.count / 5,
                                               device_ms_per_step=e.device_time_total / 5e3)
                              for e in gemm},
                gemm_ms_per_step=sum(e.device_time_total for e in gemm) / 5e3,
                launches_per_step=dict(step.launches))
            del eng, step, params, model
            torch.cuda.empty_cache()
    if "prefills" in tasks:
        policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
        for arch, what in ((cs.WHISPER_ARCH, "prefill_encoder_1500_frames"),
                           (cs.ARCH, "prefill_48_tokens")):
            model = cs.full_width_model(policy, arch=arch)
            params = model.init(0)
            g = torch.Generator(device="cuda").manual_seed(50)
            state = model.init_decode_state(1, 64, per_slot=True)
            if what.startswith("prefill_encoder"):
                frames = torch.randn((1, cs.WHISPER_FRAMES, model.cfg.d_model), generator=g,
                                     device="cuda") * 0.02
                m_rows = cs.WHISPER_FRAMES
                call = lambda i: model.prefill_encoder(params, frames, state)  # noqa: E731
            else:
                prompt = torch.randint(0, model.cfg.vocab, (1, 48), generator=g, device="cuda")
                m_rows = 48
                call = lambda i: model.decode_step(params, prompt, state)  # noqa: E731
            call(0)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            call(0)
            torch.cuda.synchronize()
            launches = {k: v for k, v in build.launch_counts().items() if v}
            body_launches = getattr(build, "body_launch_counts", dict)()
            device_ms, enqueue_ms = cs.time_ms(call, warmup=1, reps=3, samples=5)
            out["prefills"][what] = dict(arch=arch, m=m_rows, layers=model.cfg.n_layers,
                                         device_ms=device_ms, enqueue_ms=enqueue_ms,
                                         launches=launches, body_launches=body_launches,
                                         path=body(m_rows, 2))
            del model, params, state
            torch.cuda.empty_cache()
    out["build_count"] = build.BUILD_COUNT
    return out


def _key(row: dict) -> tuple:
    return (row["kernel"], row["m"], row["k"], row["n"], row["limbs"])


def _summary(runs: list[dict]) -> dict:
    """Every row, step and prefill beside the parent's and the change's
    medians; per body (the change's ``path``), the rows faster than the
    parent in both change runs and the range of the change's ratio."""
    by_arm: dict = {"parent": [], "change": []}
    for r in runs:
        by_arm[r["arm"]].append(r)
    rows = []
    for row in by_arm["change"][0]["rows"]:
        key = _key(row)
        ms = {arm: [next(x["ms"] for x in run["rows"] if _key(x) == key) for run in by_arm[arm]]
              for arm in by_arm}
        parent, change = statistics.median(ms["parent"]), statistics.median(ms["change"])
        rows.append(dict(zip(("kernel", "m", "k", "n", "limbs"), key), path=row["path"],
                         parent_ms=ms["parent"], change_ms=ms["change"],
                         change_over_parent=change / parent,
                         faster_in_both=max(ms["change"]) < min(ms["parent"]),
                         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                         share_of_bound_parent=row["bound_ms"] / parent,
                         share_of_bound_change=row["bound_ms"] / change,
                         library_f32_ms=row["library_f32_ms"],
                         change_over_library=change / row["library_f32_ms"]))
    steps = {}
    for arch in by_arm["change"][0]["steps"]:
        steps[arch] = {f"{arm}_{what}": [run["steps"][arch][what] for run in by_arm[arm]]
                       for arm in by_arm
                       for what in ("replay_event_ms", "kernel_ms_per_step", "gemm_ms_per_step")}
    prefills = {}
    for what, rec in by_arm["change"][0].get("prefills", {}).items():
        ms = {arm: [run["prefills"][what]["device_ms"] for run in by_arm[arm]] for arm in by_arm}
        prefills[what] = dict(path=rec["path"], launches=rec["launches"],
                              body_launches=rec.get("body_launches"),
                              parent_device_ms=ms["parent"], change_device_ms=ms["change"],
                              change_over_parent=(statistics.median(ms["change"])
                                                  / statistics.median(ms["parent"])))
    bodies = {}
    for path in sorted({r["path"] for r in rows}):
        ratios = [r["change_over_parent"] for r in rows if r["path"] == path]
        bodies[path] = dict(rows=len(ratios),
                            faster_in_both=sum(r["faster_in_both"] for r in rows
                                               if r["path"] == path),
                            min_change_over_parent=min(ratios),
                            max_change_over_parent=max(ratios))
    return {"summary": True, "rows": rows, "steps": steps, "prefills": prefills,
            "bodies": bodies}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the earlier tree")
    ap.add_argument("--out", default=None, help="also append every JSON line to this file")
    ap.add_argument("--tasks", default="kernels,steps,prefills",
                    help="comma-separated subset of: kernels, steps, prefills")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    tasks = [t for t in args.tasks.split(",") if t]
    if args.worker:
        print(json.dumps(_worker(args.worker, tasks)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("gemm_ab.py needs an NVIDIA GPU: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    trees = {"parent": os.path.abspath(args.parent), "change": _ROOT}
    runs = []

    def say(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    for i, arm in enumerate(ORDER):
        tree = trees[arm]
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"),
                   REPRO_TORCH_BUILD_DIR=os.path.join(_ROOT, "build", f"gemm_ab_{i}_{arm}"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                               "--tasks", args.tasks], env=env, capture_output=True, text=True,
                              cwd=tree)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise RuntimeError(f"arm {i} ({arm}) failed with exit {proc.returncode}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run.update(arm=arm, turn=i, card=card)
        say(run)
        runs.append(run)
    say({**_summary(runs), "card": card, "order": ORDER})
    return 0


if __name__ == "__main__":
    sys.exit(main())
