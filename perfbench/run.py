#!/usr/bin/env python3
"""Run one cell of the port's benchmark (``BENCHMARK.json``) on the GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Build and kernel caches go to fixed
directories inside the checkout (``build/perfbench/``).  Without a CUDA
device, or with fewer than the cell asks for, it prints no result and
exits with a non-zero code.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "perfbench"
os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(HERE), str(ROOT / "src")]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
