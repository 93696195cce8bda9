"""Keeping the port's kernel build across runs of one checkout.

The port compiles its CUDA sources at the first kernel call of every
process, into ``$REPRO_TORCH_BUILD_DIR``.  The benchmark points that at a
fixed directory of the checkout and stamps it with a hash of the sources,
flags, build module and compiler version: a later run whose stamp matches
loads and binds the library found there, as the port's loader would after
building it, and only a run that finds no stamp, or another one, builds
(the result line says which: ``kernel_build``).
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

LIB = "librepro_torch_kernels.so"
STAMP = "perfbench.stamp"


def _key(build) -> str:
    """The sources, the flags, the build module itself (its link line and
    its binding) and the compiler's version."""
    h = hashlib.sha256()
    h.update(repr((build.SOURCES, build.NVCC_FLAGS)).encode())
    h.update(Path(build.__file__).read_bytes())
    h.update(subprocess.run([build._find_nvcc(), "--version"], capture_output=True,
                            check=True).stdout)
    for src in sorted(build.csrc_dir().iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def load(build_dir: Path) -> str:
    """Make the port's kernel library ready: ``"cached"`` when a stamped
    build was loaded, ``"built"`` otherwise."""
    from repro_torch.kernels import build

    key = _key(build)
    stamp, lib = build_dir / STAMP, build_dir / LIB
    bind = getattr(build, "_bind", None)
    if (bind is not None and hasattr(build, "_LIB") and lib.exists() and stamp.exists()
            and stamp.read_text() == key):
        handle = ctypes.CDLL(str(lib))
        bind(handle)
        build._LIB = handle
        return "cached"
    stamp.unlink(missing_ok=True)
    build.library()
    stamp.write_text(key)
    return "built"
