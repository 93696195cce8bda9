"""repro_torch — the PyTorch/CUDA port of the run-time-reconfigurable
multi-precision matmul system (``repro`` is the JAX reference beside it).

Module and function names mirror ``repro`` so each counterpart is easy to
find.  Entry points run on the GPU unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.  Nothing here imports ``jax`` or ``repro``.
"""
from repro_torch.device import resolve_device  # noqa: F401
