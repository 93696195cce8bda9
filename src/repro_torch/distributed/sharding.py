"""Sharding rules: DP / FSDP / TP / EP / SP over a ``DeviceMesh``.

The reference's ``repro.distributed.sharding`` on ``torch.distributed``:
a GSPMD ``NamedSharding(mesh, PartitionSpec)`` becomes a ``NamedSharding``
of this module, which holds the mesh and the ``DTensor`` placements (one
per mesh dimension: ``Shard(d)`` where the spec puts that mesh axis on
tensor dim ``d``, else ``Replicate()``).  ``put`` is ``device_put``;
``constrain`` is ``with_sharding_constraint``.

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model') multi-pod.
  * batch            -> ('pod', 'data')   (pod is extra data parallelism)
  * TP ('heads')     -> heads / d_ff / experts / vocab on 'model'
  * SP ('sequence')  -> sequence on 'model' (archs whose head count does not
                        divide the model axis: qwen1.5-4b 20H, internvl2 14H)
  * FSDP             -> parameters additionally sharded over 'data'

The rules take a ``DeviceMesh`` or an ``AbstractMesh`` (axis names and
sizes, no processes: the counterpart of ``jax.sharding.AbstractMesh``), so
a 16 x 16 production layout can be read on one CPU.  An axis whose size
does not divide the dimension is dropped (that dimension replicates), and
so is an axis the mesh does not have: the single-pod and multi-pod meshes
share one model code, and the gradient-compression step, whose parameters
live on the ('data', 'model') sub-mesh, drops 'pod' as the reference drops
its manual axis.

``constrain`` redistributes a ``DTensor`` inside ``use_mesh`` (the
counterpart of ``jax.set_mesh``); with no mesh in use, or on a plain
tensor, it is the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

BATCH_AXES = ("pod", "data")

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


class AbstractMesh(NamedTuple):
    """A mesh's layout with no devices or processes behind it."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the mesh ``constrain`` works on (``jax.set_mesh``)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _ACTIVE_MESH.get()


def _clean_spec(axes, mesh) -> tuple:
    """``axes`` with every name the mesh does not have dropped."""
    names = set(axis_sizes(mesh))
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif isinstance(a, (tuple, list)):
            kept = tuple(n for n in a if n in names)
            out.append(kept if kept else None)
        else:
            out.append(a if a in names else None)
    return tuple(out)


def _fit_spec(axes, shape, mesh) -> tuple:
    """Drop mesh axes whose product does not divide the dim (replicate
    instead): non-divisible cases (odd vocabs, batch=1 long-context, GQA
    kv-heads < model axis) are legal configs, not errors.  The result is a
    PartitionSpec as a tuple: per dim None, a name or a tuple of names."""
    sizes = axis_sizes(mesh)
    spec = _clean_spec(axes, mesh)
    fitted = []
    for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if entry is None:
            fitted.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        kept: list[str] = []
        prod = 1
        for n in names:
            if dim % (prod * sizes[n]) == 0:
                kept.append(n)
                prod *= sizes[n]
        fitted.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(fitted)


def spec_placements(spec: tuple, mesh) -> tuple:
    """A fitted spec as ``DTensor`` placements, one per mesh dimension.
    Two axes on one dim shard it in mesh order (the spec's own order for
    every spec this module makes).  An axis of size 1 holds the whole dim
    either way, and is ``Replicate()``: a shard over one rank would only
    narrow the view ops DTensor can run (it cannot flatten two sharded
    dims, as an einsum over (batch, heads) does in torch 2.11)."""
    where = {}
    for d, entry in enumerate(spec):
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            if n is not None:
                where[n] = d
    return tuple(Shard(where[n]) if n in where and size > 1 else Replicate()
                 for n, size in axis_sizes(mesh).items())


def shard_slices(shape, placements, mesh_shape, coord) -> tuple[slice, ...]:
    """The part of a tensor of ``shape`` that the rank at mesh coordinate
    ``coord`` holds under ``placements``: one slice per tensor dim.  A dim
    sharded by several mesh dims is split by each in mesh order, each split
    as ``torch.chunk`` splits (DTensor's own layout)."""
    bounds = [[0, n] for n in shape]
    for p, n, c in zip(placements, mesh_shape, coord):
        if isinstance(p, Shard):
            lo, hi = bounds[p.dim]
            size = -(-(hi - lo) // n)
            start = min(lo + c * size, hi)
            bounds[p.dim] = [start, min(start + size, hi)]
        elif not isinstance(p, Replicate):
            raise ValueError(f"no slice of a tensor under {p}")
    return tuple(slice(lo, hi) for lo, hi in bounds)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, out = 1, []
    for n in reversed(tuple(shape)):
        out.append(stride)
        stride *= max(n, 1)
    return tuple(reversed(out))


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """Where a tensor lives on a mesh: the mesh and one placement per mesh
    dimension (``spec`` keeps the PartitionSpec they came from)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)

    def put(self, x: torch.Tensor) -> DTensor:
        """``x`` (the whole tensor, the same on every rank, on any device)
        as a DTensor laid out so: each rank slices its own part out of its
        own copy where ``x`` lies and moves only that part to its device.
        Nothing is sent between ranks."""
        mesh, placements = self.mesh, self.placements
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the sharding's mesh")
        part = x.detach()[shard_slices(x.shape, placements, mesh.shape, coord)]
        local = part.to(mesh_device(mesh)).contiguous()
        out = DTensor.from_local(local, mesh, placements, run_check=False,
                                 shape=x.shape, stride=contiguous_stride(x.shape))
        return out.requires_grad_(x.requires_grad)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Sharding constraint: inside ``use_mesh``, a DTensor redistributed to
    ``axes`` fitted to its own mesh; else (or on a plain tensor) ``x``."""
    if active_mesh() is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = spec_placements(_fit_spec(axes, x.shape, mesh), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


# ---------------------------------------------------------------------------
# Parameter shardings (by tree-path name patterns)
# ---------------------------------------------------------------------------


def _spec_for(path: str, ndim: int, cfg, stacked: bool) -> tuple:
    """Return partition axes for the trailing (non-layer-stack) dims."""
    tp = cfg.attn_shard == "heads"  # TP scheme; SP keeps weights unsharded on model
    fsdp = ("data",) if cfg.fsdp else None
    mdl = "model"

    def tail(*axes):
        return ((None,) if stacked else ()) + axes

    # --- embeddings / logits ---
    if "unembed" in path:  # (D, V)
        if path.endswith(".b"):
            return tail(mdl)
        return tail(fsdp, mdl)
    if "embed" in path:  # (V, D)
        return tail(mdl, fsdp)
    # --- MoE ---
    if "router" in path:
        return tail(fsdp, None) if ndim - stacked == 2 else tail(None)
    # Expert weights: EP (E over model) + ZeRO-3 (D or F over data).
    if any(s in path for s in ("moe.gate", "moe.up")):  # (E, D, F)
        return tail(mdl, fsdp, None)
    if "moe.down" in path:  # (E, F, D)
        return tail(mdl, None, fsdp)
    # --- ssm ---
    if "in_proj" in path:  # (D, d_proj) — output channels model-sharded
        return tail(fsdp, mdl if tp else None)
    if "out_proj" in path:  # (d_inner, D)
        return tail(mdl if tp else None, fsdp)
    if "conv_w" in path:  # (K, C)
        return tail(None, mdl if tp else None)
    if any(s in path for s in ("a_log", "dt_bias", "d_skip")):
        return tail(mdl if tp else None)
    # --- griffin rg-lru ---
    if any(s in path for s in ("in_x", "in_gate")):  # (D, W)
        return tail(fsdp, mdl if tp else None)
    if any(s in path for s in (".wa.", ".wx.")):  # (W, W)
        return tail(fsdp, mdl if tp else None)
    if path.endswith("lam"):
        return tail(mdl if tp else None)
    if ".out." in path or path.endswith("out.w"):  # (W, D)
        return tail(mdl if tp else None, fsdp)
    # --- attention ---
    if any(s in path for s in ("wq", "wk", "wv")):
        if path.endswith(".b"):  # bias (H*hd,)
            return tail(mdl if tp else None)
        return tail(fsdp, mdl if tp else None)
    if "wo" in path:  # (H*hd, D)
        return tail(mdl if tp else None, fsdp)
    # --- mlp ---
    if any(s in path for s in ("gate", "up")):
        if path.endswith(".b"):
            return tail(mdl if tp else None)
        return tail(fsdp, mdl if tp else None)
    if "down" in path:
        if path.endswith(".b"):
            return tail(None)
        return tail(mdl if tp else None, fsdp)
    # --- norms / scalars / everything else: replicated
    return tail(*([None] * (ndim - (1 if stacked else 0))))


def _is_stacked(path: str) -> bool:
    head = path.split(".", 1)[0]
    return head in ("layers", "enc_layers", "dec_layers", "super", "rem", "moe_layers")


def _map_paths(fn, tree, prefix=""):
    """``fn(dotted path, leaf)`` over a tree of dicts, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_shardings(params: Any, cfg, mesh) -> Any:
    """Tree of ``NamedSharding`` matching ``params`` (anything with a
    ``shape``).  Layer-stacked leaves get a leading None axis."""

    def one(path, leaf):
        ndim = len(leaf.shape)
        axes = tuple(_spec_for(path, ndim, cfg, _is_stacked(path)))[:ndim]
        axes = axes + (None,) * (ndim - len(axes))
        return NamedSharding(mesh, _fit_spec(axes, leaf.shape, mesh))

    return _map_paths(one, params)


def input_shardings(batch: Any, mesh) -> Any:
    """Batch inputs: leading dim over ('pod','data'), rest replicated."""

    def one(_, leaf):
        axes = (BATCH_AXES,) + (None,) * (len(leaf.shape) - 1)
        return NamedSharding(mesh, _fit_spec(axes, leaf.shape, mesh))

    return _map_paths(one, batch)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def put(tree: Any, shardings: Any) -> Any:
    """``jax.device_put(tree, shardings)``: every leaf of ``tree`` laid out
    by the ``NamedSharding`` at its place in ``shardings``."""
    if isinstance(tree, dict):
        return {k: put(v, shardings[k]) for k, v in tree.items()}
    return shardings.put(tree)


# ---------------------------------------------------------------------------
# Decode-state shardings (KV caches / SSM / RG-LRU states)
# ---------------------------------------------------------------------------


def decode_state_shardings(state: Any, cfg, mesh) -> Any:
    """The DecodeState's structure with a ``NamedSharding`` at every tensor
    leaf (None stays None).

    KV caches: batch over ('pod','data'), kv-heads over 'model' when the head
    count divides the axis (GQA kv < model_size replicates KV — the standard
    TP-vs-GQA trade).  SSM / RG-LRU states: channels/heads over 'model'."""
    model_n = axis_sizes(mesh).get("model", 1)
    tp = cfg.attn_shard == "heads"
    kv_div = cfg.n_kv_heads and cfg.n_kv_heads % model_n == 0 and tp
    mdl = "model" if tp else None

    def one(name, leaf):
        if leaf is None:
            return None
        nd = len(leaf.shape)
        if name in ("k", "v", "k_scale", "v_scale"):
            axes = (None,) * (nd - 4) + (BATCH_AXES, None, "model" if kv_div else None, None)
        elif name == "conv":
            axes = (None,) * (nd - 3) + (BATCH_AXES, None, mdl)
        elif name == "ssm":
            axes = (None,) * (nd - 4) + (BATCH_AXES, mdl, None, None)
        elif name == "h":
            axes = (None,) * (nd - 2) + (BATCH_AXES, mdl)
        elif name == "enc_out":
            axes = (BATCH_AXES,) + (None,) * (nd - 1)
        else:  # pos / length / position scalars, page tables and pools
            axes = (None,) * nd
        return NamedSharding(mesh, _fit_spec(axes[:nd], leaf.shape, mesh))

    def node(n):
        return dataclasses.replace(n, **{f.name: one(f.name, getattr(n, f.name))
                                         for f in dataclasses.fields(n)})

    return dataclasses.replace(
        state, caches={key: [node(n) for n in layers] for key, layers in state.caches.items()},
        position=one("position", state.position), enc_out=one("enc_out", state.enc_out))
