"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), leaf by leaf, with no
process group: both are read on abstract meshes (the reference's
``jax.sharding.AbstractMesh``, the port's ``AbstractMesh``).

For every architecture and the meshes (4, 2) ('data', 'model'), (2, 2, 2)
('pod', 'data', 'model') and the production (16, 16): the port's
PartitionSpec (as a tuple) equals the reference's, and its ``DTensor``
placements are the ones that spec names (``Shard(d)`` on each mesh
dimension the spec puts on tensor dim ``d``, else ``Replicate()``).
Parameters are read on the full configs' shapes (the reference's
``eval_shape``, no memory) and on the smoke configs' trees that the
port's own ``init`` makes; inputs on batches of several sizes; decode
states on both packages' ``init_decode_state`` (the reference stacks a
segment's layers on a leading axis, the port keeps one node per layer).
``constrain`` is the identity, bit for bit, with no mesh in use and on a
plain tensor inside one.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.distributed import sharding as jsh
from repro.models import build_model as j_build_model

from repro_torch import tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import sharding as tsh
from repro_torch.models import build_model

MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
}


def _meshes(name):
    shape, axes = MESHES[name]
    return JAbstractMesh(shape, axes), tsh.AbstractMesh(shape, axes)


def _norm(spec, ndim: int) -> tuple:
    """A spec as a tuple of ``ndim`` entries (None, a name or a tuple of
    names; a one-name tuple is the name)."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = tuple(e) if len(e) > 1 else (e[0] if e else None)
        out.append(e)
    return tuple(out)


def _placements(spec: tuple, axes) -> tuple:
    where = {}
    for d, e in enumerate(spec):
        for n in (e if isinstance(e, tuple) else (e,)):
            if n is not None:
                where[n] = d
    return tuple(Shard(where[n]) if n in where else Replicate() for n in axes)


def _check(port, ref, ndim: int, axes, what: str) -> None:
    want = _norm(ref.spec, ndim)
    assert _norm(port.spec, ndim) == want, (what, port.spec, want)
    assert port.placements == _placements(want, axes), (what, port.placements)


def _paths(tree_, prefix=""):
    if isinstance(tree_, dict):
        for k in sorted(tree_):
            yield from _paths(tree_[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree_


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_full_config(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.key(0))
    want = dict(_paths(jsh.param_shardings(shapes, jcfg, jmesh)))
    got = dict(_paths(tsh.param_shardings(shapes, tcfg, tmesh)))
    leaves = dict(_paths(shapes))
    assert sorted(got) == sorted(want)
    for path, leaf in leaves.items():
        _check(got[path], want[path], len(leaf.shape), tmesh.axis_names, path)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_of_the_ports_own_tree(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = j_get_smoke_config(arch), get_smoke_config(arch)
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.key(0))
    params = build_model(tcfg, device="cpu").init(0)
    leaves = dict(_paths(params))
    assert {p: tuple(x.shape) for p, x in leaves.items()} == {
        p: tuple(s.shape) for p, s in _paths(shapes)}
    want = dict(_paths(jsh.param_shardings(shapes, jcfg, jmesh)))
    got = dict(_paths(tsh.param_shardings(params, tcfg, tmesh)))
    for path, leaf in leaves.items():
        _check(got[path], want[path], leaf.dim(), tmesh.axis_names, path)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rows", [1, 6, 8, 32, 512])
def test_input_shardings(rows, mesh):
    jmesh, tmesh = _meshes(mesh)
    batch = {"tokens": np.zeros((rows, 16), np.int32), "labels": np.zeros((rows, 16), np.int32),
             "frames": np.zeros((rows, 4, 8), np.float32)}
    want = jsh.input_shardings(batch, jmesh)
    got = tsh.input_shardings(batch, tmesh)
    for k, x in batch.items():
        _check(got[k], want[k], x.ndim, tmesh.axis_names, k)


def _ref_node(jstate, key):
    node = jstate.caches
    for part in key.split("/"):
        node = node[part]
    return node


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_shardings(arch, mesh, kv):
    jmesh, tmesh = _meshes(mesh)
    jcfg = dataclasses.replace(j_get_smoke_config(arch), kv_cache_dtype=kv)
    tcfg = dataclasses.replace(get_smoke_config(arch), kv_cache_dtype=kv)
    enc = 8 if jcfg.family == "encdec" else 0
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg, device="cpu")
    jshape = jax.eval_shape(lambda: jmodel.init_decode_state(16, 32, enc_len=enc))
    jstate = jsh.decode_state_shardings(jshape, jcfg, jmesh)
    state = tmodel.init_decode_state(16, 32, enc_len=enc)
    got = tsh.decode_state_shardings(state, tcfg, tmesh)
    n = 0
    for key, nodes in state.caches.items():
        for node, gnode in zip(nodes, got.caches[key], strict=True):
            for f in dataclasses.fields(node):
                leaf, want = getattr(node, f.name), getattr(_ref_node(jstate, key), f.name)
                wshape = getattr(_ref_node(jshape, key), f.name)
                if leaf is None:
                    assert want is None and getattr(gnode, f.name) is None
                    continue
                spec = tuple(want.spec) + (None,) * (len(wshape.shape) - len(tuple(want.spec)))
                if len(wshape.shape) == leaf.dim() + 1:  # the reference's layer axis
                    assert spec[0] is None
                    spec = spec[1:]
                ref = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(*spec))
                _check(getattr(gnode, f.name), ref, leaf.dim(), tmesh.axis_names,
                       f"{key}.{f.name}")
                n += 1
    _check(got.position, jstate.position, state.position.dim(), tmesh.axis_names, "position")
    if state.enc_out is not None:
        _check(got.enc_out, jstate.enc_out, state.enc_out.dim(), tmesh.axis_names, "enc_out")
    assert n > 0


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8, 16)).astype(np.float32))
    assert tsh.active_mesh() is None
    assert tsh.constrain(x, tsh.BATCH_AXES, None, "model") is x
    with tsh.use_mesh(tsh.AbstractMesh((2, 2), ("data", "model"))):
        # a plain tensor inside a mesh: the identity too (the step reads the
        # model's own plain tensors as replicated)
        assert tsh.constrain(x, tsh.BATCH_AXES, None, "model") is x
    assert tsh.active_mesh() is None


def test_model_forward_is_unchanged_by_the_constrain_sites():
    """``apply`` with the sites in the code and no mesh equals ``apply`` with
    every site replaced by a function that returns its input (bit for
    bit, logits and gradients)."""
    from repro_torch.core.policy import NATIVE_F32
    from repro_torch.models import layers, lm

    cfg = get_smoke_config("qwen1.5-0.5b").with_policy(NATIVE_F32)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32))}

    def run():
        live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        logits, _ = model.apply(tree.unflatten(params, live), batch)
        grads = torch.autograd.grad(logits.square().mean(), live)
        return logits.detach(), grads

    seen = []

    def spy(x, *axes):
        seen.append(axes)
        return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "constrain", spy)
        mp.setattr(layers, "constrain", spy)
        want_logits, want_grads = run()
    logits, grads = run()
    assert len(seen) == cfg.n_layers * 4 + 2  # block input, q/k/v per layer; embed, logits
    assert torch.equal(logits, want_logits)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


@pytest.mark.parametrize("shape,placements,mesh_shape", [
    ((10, 6), (Shard(0), Shard(0)), (2, 2)),   # one dim split twice, unevenly
    ((8, 12), (Shard(0), Shard(1)), (2, 3)),
    ((8, 12), (Replicate(), Shard(1)), (2, 4)),
    ((3, 5, 7), (Shard(2), Replicate(), Shard(1)), (3, 2, 2)),
])
def test_shard_slices_cover_the_tensor_as_torch_chunk_splits_it(shape, placements, mesh_shape):
    """Each coordinate's part is torch.chunk's piece (DTensor's layout), and
    the parts of the coordinates that shard a tensor cover it exactly once."""
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    seen = torch.zeros(shape, dtype=torch.int64)
    for coord in np.ndindex(*mesh_shape):
        want = x
        for p, n, c in zip(placements, mesh_shape, coord):
            if isinstance(p, Shard):
                chunks = torch.chunk(want, n, dim=p.dim)
                want = chunks[c] if c < len(chunks) else want.narrow(p.dim, 0, 0)
        got = x[tsh.shard_slices(shape, placements, mesh_shape, coord)]
        assert torch.equal(got, want), (coord, got, want)
        if all(c == 0 or isinstance(p, Shard) for p, c in zip(placements, coord)):
            seen[tsh.shard_slices(shape, placements, mesh_shape, coord)] += 1
    assert bool((seen == 1).all())


def test_contiguous_stride():
    assert tsh.contiguous_stride((3, 5, 7)) == torch.empty(3, 5, 7).stride()
    assert tsh.contiguous_stride(()) == ()
