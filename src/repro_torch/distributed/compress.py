"""int8 error-feedback gradient compression for the cross-pod reduction.

The reference's ``repro.distributed.compress`` on ``torch.distributed``.
Cross-pod gradient all-reduce is the longest link, so gradients cross it as
block-scaled int8 with an error-feedback residual carried to the next step
(1-bit-Adam-family result: EF keeps SGD/Adam convergence): 4x fewer bytes
on the 'pod' axis.

Only int8 codes and f32 block scales cross the pod process group: each
rank quantizes its pod's gradient, ``all_gather``s codes and scales over
'pod', and sums the dequantized blocks over the pods in pod order, so
every rank gets the same bits.  Block 512, ``scale = max|x| / 127 +
1e-20``, round half to even, clip to +-127, all as the reference.  A
gradient that is a ``DTensor`` (the pod's own layout over the other mesh
axes) is cut into the blocks of the whole tensor, as the reference's
``shard_map`` manual over 'pod' alone sees it, but each rank quantizes and
sends only its own share of it (``ef_reduce_leaf``), and the result comes
back in the gradient's placements.

``pod_traffic`` counts the bytes each rank put into the pod group's
gathers, by dtype, since the last ``reset_pod_traffic``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch import tree
from repro_torch.distributed.sharding import axis_sizes, contiguous_stride, shard_slices

Tensor = torch.Tensor

_BLOCK = 512

#: bytes this rank sent into the pod group's gathers, by dtype
_TRAFFIC: dict[str, int] = {}


def reset_pod_traffic() -> None:
    _TRAFFIC.clear()


def pod_traffic() -> dict[str, int]:
    """``{dtype name: bytes}`` this rank gathered over 'pod' since the last
    reset."""
    return dict(_TRAFFIC)


def _quantize_block(x: Tensor) -> tuple[Tensor, Tensor]:
    """(blocks, 512) int8 codes and (blocks, 1) f32 scales of ``x``
    flattened and zero-padded to whole blocks."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-20
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize_block(q: Tensor, scale: Tensor, shape, size: int) -> Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)[:size].reshape(shape)


def compress_decompress(x: Tensor) -> tuple[Tensor, Tensor]:
    """Round-trip int8 quantization; returns (approx, residual)."""
    q, s = _quantize_block(x)
    approx = _dequantize_block(q, s, x.shape, x.numel())
    return approx, x - approx


def pod_free(mesh):
    """The mesh without its 'pod' axis: where the parameters, their
    gradients and the residuals live when gradients cross 'pod' compressed
    ('pod' is then a plain process group, as the reference's ``shard_map``
    is manual over it alone)."""
    rest = tuple(n for n in axis_sizes(mesh) if n != "pod")
    if not rest:
        raise ValueError("gradient compression needs a mesh axis besides 'pod'")
    return mesh[rest]


def _gather(x: Tensor, group) -> list[Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    key = str(x.dtype).removeprefix("torch.")
    _TRAFFIC[key] = _TRAFFIC.get(key, 0) + x.numel() * x.element_size()
    return parts


def _block_ids(x: Tensor) -> Tensor:
    """The global block (of 512, the reference's blocks of the whole tensor
    flattened) of each element of ``x``'s local part, in the local part's
    row-major order, which is the blocks' order too."""
    if not isinstance(x, DTensor):
        return torch.arange(x.numel(), device=x.device) // _BLOCK
    mesh = x.device_mesh
    dev = x.to_local().device
    ids = torch.zeros((), dtype=torch.int64, device=dev)
    for part, stride in zip(shard_slices(x.shape, x.placements, mesh.shape,
                                         mesh.get_coordinate()),
                            contiguous_stride(x.shape)):
        ids = ids[..., None] + torch.arange(part.start, part.stop, device=dev) * stride
    return ids.reshape(-1) // _BLOCK


def _replica_split(x: Tensor) -> tuple[list[int], int, int]:
    """How the ranks that hold one part of ``x`` share its work: the mesh
    dims that replicate it, this rank's index among its replicas (row-major
    over those dims) and their count.  A part with fewer elements than
    replicas is not split."""
    if not isinstance(x, DTensor):
        return [], 0, 1
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    dims = [i for i, p in enumerate(x.placements)
            if not isinstance(p, Shard) and mesh.shape[i] > 1]
    k, n = 0, 1
    for i in dims:
        k, n = k * mesh.shape[i] + coord[i], n * mesh.shape[i]
    if x.to_local().numel() < n:
        return [], 0, 1
    return dims, k, n


def _chunk(size: int, k: int, n: int) -> tuple[int, int]:
    """The k-th of n near-equal contiguous chunks of ``size`` elements."""
    base, extra = divmod(size, n)
    lo = k * base + min(k, extra)
    return lo, lo + base + (k < extra)


def _assemble(chunk: Tensor, size: int, x: DTensor, dims: list[int], n: int) -> Tensor:
    """Every replica's chunk, gathered over the replicating mesh dims (inside
    the pod), in order: the whole local part of ``size`` elements."""
    width = -(-size // n)
    buf = torch.nn.functional.pad(chunk, (0, width - chunk.shape[-1]))
    for i in reversed(dims):
        parts = [torch.empty_like(buf) for _ in range(x.device_mesh.shape[i])]
        dist.all_gather(parts, buf, group=x.device_mesh.get_group(i))
        buf = torch.cat(parts, dim=-1)
    spans = [_chunk(size, j, n) for j in range(n)]
    return torch.cat([buf[..., j * width: j * width + hi - lo]
                      for j, (lo, hi) in enumerate(spans)], dim=-1)


def ef_reduce_leaf(g: Tensor, r: Tensor, group) -> tuple[Tensor, Tensor]:
    """Error-feedback int8 mean-reduction of one leaf over ``group`` (the
    pod process group): ``(reduced, new_residual)``.  ``g`` and ``r`` hold
    this pod's gradient and residual, plain tensors or DTensors of one
    layout on the pod-free mesh (the result keeps it).

    The codes and scales are the reference's, of the whole tensor's blocks,
    bit for bit, yet each rank quantizes and sends only its own elements:
    the blocks' max |x| is reduced over the mesh dims that shard the leaf,
    and the ranks that replicate a part split it between them and gather
    the results back (both inside the pod).  Over 'pod' a rank sends its
    share of the leaf as int8 codes and the scales of the blocks it
    touches."""
    local_g = g.to_local() if isinstance(g, DTensor) else g
    local_r = r.to_local() if isinstance(r, DTensor) else r
    corrected = (local_g + local_r).reshape(-1)
    ids = _block_ids(g)
    amax = torch.zeros(-(-g.numel() // _BLOCK), dtype=torch.float32, device=ids.device)
    amax = amax.scatter_reduce(0, ids, corrected.abs(), "amax")
    if isinstance(g, DTensor):
        for i, p in enumerate(g.placements):
            if isinstance(p, Shard) and g.device_mesh.shape[i] > 1:
                dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                                group=g.device_mesh.get_group(i))
    scale = amax / 127.0 + 1e-20
    dims, k, n = _replica_split(g)
    lo, hi = _chunk(corrected.numel(), k, n)
    mine = corrected[lo:hi]
    blocks, where = torch.unique_consecutive(ids[lo:hi], return_inverse=True)
    s = scale[blocks]
    q = torch.clamp(torch.round(mine / s[where]), -127, 127).to(torch.int8)
    new_r = mine - q.to(torch.float32) * s[where]  # error feedback
    q_all, s_all = _gather(q, group), _gather(s, group)
    summed = q_all[0].to(torch.float32) * s_all[0][where]
    for q_i, s_i in zip(q_all[1:], s_all[1:]):  # pod order, as jnp.sum over axis 0
        summed = summed + q_i.to(torch.float32) * s_i[where]
    reduced = summed / len(q_all)
    if n > 1:
        reduced, new_r = _assemble(torch.stack([reduced, new_r]), corrected.numel(), g,
                                   dims, n).unbind()
    reduced, new_r = (t.reshape(local_g.shape) for t in (reduced, new_r))
    if not isinstance(g, DTensor):
        return reduced, new_r
    return tuple(DTensor.from_local(t, g.device_mesh, g.placements, run_check=False,
                                    shape=g.shape, stride=g.stride())
                 for t in (reduced, new_r))


def ef_reduce_tree(grads: Any, residuals: Any, group) -> tuple[Any, Any]:
    pairs = [ef_reduce_leaf(g, r, group)
             for g, r in zip(tree.leaves(grads), tree.leaves_up_to(grads, residuals))]
    return (tree.unflatten(grads, [p[0] for p in pairs]),
            tree.unflatten(grads, [p[1] for p in pairs]))


def compressed_psum_pod(grads: Any, residuals: Any, mesh) -> tuple[Any, Any]:
    """Error-feedback compressed mean-reduction over the 'pod' mesh axis.

    grads/residuals: trees replicated over pod in their sharded layout
    (plain tensors, or DTensors on ``pod_free(mesh)``).  Returns
    (reduced_grads, new_residuals); a mesh without 'pod' returns them as
    they are."""
    if "pod" not in axis_sizes(mesh):
        return grads, residuals
    return ef_reduce_tree(grads, residuals, mesh.get_group("pod"))
