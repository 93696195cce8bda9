"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU, and raises when there is none: the port never
    carries on silently on the CPU.  The CPU is used only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and found no GPU; pass "
                "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def backend_of(device) -> str:
    """Planner backend name for a torch device ('gpu' | 'cpu')."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def require_full_f32_matmul(device) -> None:
    """TF32 would re-round every f32 pass of the limb algebra and break the
    M24 ceiling: set it off for CUDA and check that it stayed off."""
    if torch.device(device).type != "cuda":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not disable TF32 for float32 matmuls")
