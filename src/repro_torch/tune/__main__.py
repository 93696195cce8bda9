"""Autotuner CLI: measure the candidate space, persist a tuning table.

    PYTHONPATH=src python -m repro_torch.tune --sizes 256,1024 --out build/tuning/gpu.json
    PYTHONPATH=src python -m repro_torch.tune --sizes 64 --backend cpu --out /tmp/cpu.json

The backend is the GPU unless ``--backend cpu`` asks for the CPU.  The
default output path is ``tuning/<backend>.json`` — the location the
planner's ``TUNE_TABLE=tuning`` directory form resolves per backend.
"""

from __future__ import annotations

import argparse

from repro_torch.core.precision import Mode
from repro_torch.tune.runner import DEFAULT_BLOCKS, tune


def _parse_blocks(spec: str) -> tuple[tuple[int, int, int], ...]:
    out = []
    for part in spec.split(","):
        bm, bn, bk = (int(x) for x in part.strip().split("x"))
        out.append((bm, bn, bk))
    return tuple(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Microbenchmark (mode x depth x impl x block) candidates "
        "and write a versioned tuning table for the matmul planner.",
    )
    ap.add_argument("--sizes", default="128,256,512", help="square sizes, comma-sep")
    ap.add_argument("--iters", type=int, default=3, help="timed iterations per cell")
    ap.add_argument("--modes", default="M8,M16,M24", help="RMPM modes to measure")
    ap.add_argument(
        "--impls",
        default="",
        help="comma-sep impl subset (default: native,xla,pallas,tile on the "
        "GPU; native,xla on the CPU)",
    )
    ap.add_argument("--max-depth", type=int, default=1, help="max Strassen depth")
    ap.add_argument(
        "--blocks",
        default=",".join("x".join(map(str, b)) for b in DEFAULT_BLOCKS),
        help="kernel bm x bn x bk grid, comma-sep (e.g. 128x128x512)",
    )
    ap.add_argument("--align", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="", choices=("", "gpu", "cpu"),
                    help="where to measure (default: the GPU, raising when "
                    "there is none)")
    ap.add_argument(
        "--out",
        default="",
        help="output path (default: tuning/<backend>.json)",
    )
    args = ap.parse_args(argv)

    table = tune(
        tuple(int(s) for s in args.sizes.split(",")),
        backend=args.backend or None,
        modes=tuple(Mode[m.strip()] for m in args.modes.split(",")),
        impls=tuple(s.strip() for s in args.impls.split(",")) if args.impls else None,
        max_depth=args.max_depth,
        align=args.align,
        blocks=_parse_blocks(args.blocks),
        iters=args.iters,
        seed=args.seed,
        progress=lambda line: print(line, flush=True),
    )
    out = args.out or f"tuning/{table.backend}.json"
    table.save(out)
    bal = table.balance
    print(
        f"wrote {out}: {len(table.records)} records, fingerprint "
        f"{table.fingerprint}"
    )
    print(
        f"fitted balance: peak {bal.peak_flops:.3g} FLOP/s, "
        f"bw {bal.hbm_bw:.3g} B/s ({bal.source})"
    )


if __name__ == "__main__":
    main()
