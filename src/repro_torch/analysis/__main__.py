"""CLI gate: ``python -m repro_torch.analysis`` runs all three passes and
exits nonzero on any violation.

* capture-hygiene linter over ``--src`` (default: the port's
  ``src/repro_torch`` tree, located relative to this package so the gate
  works from any cwd);
* precision-flow + dispatch audits over every registered hot path
  (``--quick`` restricts to the kernel/train subset — no engine builds) on
  the GPU, where the kernels run; ``--device cpu`` runs each kernel's plain
  version instead, which its wrapper charges as the kernel;
* ``--report out.json`` writes the machine-readable violation report.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.hotpaths import all_paths, check
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.report import format_report, write_json


def _default_src() -> str:
    # src/repro_torch/analysis/__main__.py -> src/repro_torch/
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--src", default=None,
                    help="source tree to lint (default: src/repro_torch)")
    ap.add_argument("--quick", action="store_true",
                    help="kernel/train hot paths only (skip engine builds)")
    ap.add_argument("--device", default=None,
                    help="torch device of the hot paths; default: the GPU "
                         "(raises when there is none)")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--skip-paths", action="store_true")
    ap.add_argument("--report", default=None, metavar="OUT.json",
                    help="write the JSON violation report")
    args = ap.parse_args(argv)

    violations, checked = [], []
    if not args.skip_lint:
        src = args.src or _default_src()
        lint_v, files = lint_paths(src)
        violations += lint_v
        checked += [f"lint:{os.path.relpath(p, src)}" for p in files]
    if not args.skip_paths:
        path_v, names = check(all_paths(quick=args.quick, device=args.device))
        violations += path_v
        checked += names

    print(format_report(violations, checked))
    if args.report:
        write_json(args.report, violations, checked)
        print(f"report -> {args.report}")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
