"""Process group and mesh construction.

The reference's ``repro.launch.mesh`` on ``torch.distributed``: a mesh is a
``DeviceMesh`` (``init_device_mesh``) with the reference's axis names over
the ranks of the default process group.  Nothing here runs at import.

The backend follows the device: NCCL for the GPU, gloo only for a run that
asked for the CPU.  A GPU mesh never runs over gloo, and a failed NCCL
init raises.  Under ``torchrun`` the group comes from its environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); a plain process is rank 0 of a world of one, over a free
port on localhost.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device=None, *, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None) -> torch.device:
    """Bring up the default process group (once) and return this rank's
    device.  ``device`` None is the GPU (``cuda:LOCAL_RANK``), raising when
    there is none; ``init_method`` / ``rank`` / ``world_size`` default to
    ``torchrun``'s environment, else to a world of one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if init_method is None:
        init_method = ("env://" if "MASTER_ADDR" in os.environ
                       else f"tcp://localhost:{_free_port()}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return dev


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default group (brought up here if it is not yet).  The world size must
    be the product of ``shape``."""
    dev = init_distributed(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks; "
                         f"this run has {world}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_local_mesh(device=None):
    """Every rank of the run as a (data, model) = (world, 1) mesh."""
    init_distributed(device)
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod.  Only a
    run of that many ranks can hold it (reading its layout without the
    devices is ``distributed.sharding.AbstractMesh``'s job)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
