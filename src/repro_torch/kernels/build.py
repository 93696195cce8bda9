"""Build, load and bind the port's CUDA kernels.

The five kernels live in ``repro_torch/csrc/*.cu`` with a plain C
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

SOURCES = ("quantize_mantissa.cu", "limb_matmul.cu", "tile_matmul.cu",
           "limb_matmul_dd.cu", "decode_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
#: environment variable overriding the build directory
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"

BUILD_COUNT = 0
#: the compilers' output of the last build (with ``verbose=True`` it holds
#: ptxas's registers, shared memory and spills per kernel)
BUILD_LOG = ""
LAUNCHES = {"quantize_mantissa": 0, "limb_matmul": 0, "tile_matmul": 0,
            "limb_matmul_dd": 0, "decode_attention": 0}
#: the same launches of the limb, mode-map and double-f32 kernels, by the
#: device body they ran (``kernels.limb_matmul.ops.gemm_body``)
BODY_LAUNCHES = {"skinny": 0, "mma": 0, "wide": 0}

_LIB = None
#: devices whose kernels ``prepare_device`` has prepared
_PREPARED: set[int] = set()


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "csrc"


def build_dir() -> Path:
    override = os.environ.get(BUILD_DIR_ENV)
    if override:
        return Path(override)
    # src/repro_torch/kernels/build.py -> <checkout>/build/repro_torch
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def body_launch_counts() -> dict[str, int]:
    return dict(BODY_LAUNCHES)


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
    global BUILD_COUNT, BUILD_LOG
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
    BUILD_LOG = "\n".join(logs)
    if verbose:
        print(BUILD_LOG, flush=True)
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
    # (a, b, c, workspace, m, n, k, limbs, bm, bn, bk, splits, stream)
    lib.rmpm_limb_matmul.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.rmpm_limb_matmul.restype = i
    # (a, b, c, workspace, map, map_ndim, m, n, k, kmax, bm, bn, bk, splits, stream)
    lib.rmpm_tile_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.rmpm_tile_matmul.restype = i
    # (a, b, hi, lo, workspace, m, n, k, limbs, bm, bn, bk, splits, stream)
    lib.rmpm_limb_matmul_dd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.rmpm_limb_matmul_dd.restype = i
    # (q, k, v, k_sb, k_sr, v_sb, v_sr, q_pos, kv_pos, pos_sb, workspace, out,
    #  qk_mode, av_mode, b, s, hkv, g, hd, lq, lv, rounding, causal, window,
    #  scale, stream)
    lib.rmpm_decode_attention.argtypes = [p, p, p, ll, ll, ll, ll, p, p, ll, p, p, p, p,
                                          i, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.rmpm_decode_attention.restype = i
    lib.rmpm_error_string.argtypes = [i]
    lib.rmpm_error_string.restype = ctypes.c_char_p
    # per device: allow the skinny and tensor-core tile kernels their rings,
    # the decode-attention kernel its tiles
    for fn in _prepare_fns(lib):
        fn.argtypes = []
        fn.restype = i


def _prepare_fns(lib: ctypes.CDLL) -> tuple:
    return (lib.rmpm_limb_matmul_prepare, lib.rmpm_tile_matmul_prepare,
            lib.rmpm_decode_attention_prepare)


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build(verbose=verbose)))
        _bind(lib)
        _LIB = lib
    return _LIB


def prepare_device(lib: ctypes.CDLL) -> None:
    """Once per device, on the current device before its first launch of the
    limb, mode-map or decode-attention kernel: allow the first two's skinny
    and tensor-core tile instantiations the dynamic shared memory of their
    rings (``rmpm::allow_smem``), and the last its tiles.  The
    port's CUDA graphs capture a step only after running it once eagerly
    (``serve.graphs.CompiledStep``), so this runs before any capture."""
    import torch

    index = torch.cuda.current_device()
    if index in _PREPARED:
        return
    for fn in _prepare_fns(lib):
        check_launch(lib, fn(), "allowing the kernels their shared memory")
    _PREPARED.add(index)


def refuse_autograd(what: str, *operands) -> None:
    """Raise ``NotImplementedError`` when grad is enabled and an operand
    requires grad.  The kernels have no backward pass, and neither have the
    TPU kernels they replace: the reference's ``jax.grad`` through
    ``pallas_call`` raises.  A kernel writes into a tensor its wrapper
    allocates, so on the card its result would carry no ``grad_fn`` and the
    weights behind it would silently get no gradient.  Every wrapper calls
    this first, on the CPU (plain version) as on the card, so the two
    cannot differ."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in operands):
        raise NotImplementedError(
            f"{what} has no backward pass (the reference's Pallas kernels have "
            "none: jax.grad through pallas_call raises NotImplementedError); "
            "train with impl='xla' or impl='native'")


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
