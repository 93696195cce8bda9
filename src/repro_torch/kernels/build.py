"""Build, load and bind the port's CUDA kernels.

The three kernels live in ``repro_torch/csrc/*.cu`` with a plain C
interface.  At first use every source is compiled by its own ``nvcc``
process (all started together) and the objects are linked into ONE shared
library under ``build/repro_torch/``, which is loaded with ``ctypes``.
PyTorch's headers are kept out of the sources, so the build takes seconds.
There is no fallback: a missing compiler or a failed build raises.

``BUILD_COUNT`` counts builds in this process; it must stay 1 however often
precision modes change (the mode reaches the kernels as data).  ``LAUNCHES``
counts kernel launches per kernel: each wrapper adds one exactly where it
launches, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

SOURCES = ("quantize_mantissa.cu", "limb_matmul.cu", "tile_matmul.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
#: environment variable overriding the build directory
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"

BUILD_COUNT = 0
LAUNCHES = {"quantize_mantissa": 0, "limb_matmul": 0, "tile_matmul": 0}

_LIB = None


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "csrc"


def build_dir() -> Path:
    override = os.environ.get(BUILD_DIR_ENV)
    if override:
        return Path(override)
    # src/repro_torch/kernels/build.py -> <checkout>/build/repro_torch
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are compiled at "
        "first use and need the CUDA toolkit (there is no fallback)")


def _build(verbose: bool = False) -> Path:
    global BUILD_COUNT
    nvcc = _find_nvcc()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    src = csrc_dir()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for name in SOURCES:
        obj = out / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(src), "-c",
               str(src / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failures, logs = [], [], []
    for name, obj, proc in procs:  # every process is waited for
        log, _ = proc.communicate()
        logs.append(f"== {name} ==\n{log}")
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
        objs.append(str(obj))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    if verbose:
        print("\n".join(logs), flush=True)
    lib = out / "librepro_torch_kernels.so"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-Xcompiler", "-fPIC", "-o", str(lib), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    BUILD_COUNT += 1
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rmpm_quantize_mantissa.argtypes = [p, p, ll, i, i, p]
    lib.rmpm_quantize_mantissa.restype = i
    lib.rmpm_limb_matmul.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.rmpm_limb_matmul.restype = i
    lib.rmpm_tile_matmul.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.rmpm_tile_matmul.restype = i
    lib.rmpm_error_string.argtypes = [i]
    lib.rmpm_error_string.restype = ctypes.c_char_p


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build(verbose=verbose)))
        _bind(lib)
        _LIB = lib
    return _LIB


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch was refused (``cudaGetLastError`` != 0)."""
    if code != 0:
        msg = lib.rmpm_error_string(code)
        raise RuntimeError(
            f"{what}: CUDA launch failed with error {code} "
            f"({msg.decode() if msg else 'unknown'})")


def current_stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
