"""Rank programs of the port's multi-process tests (no test of its own):

    python tests/torch_dist_ranks.py <scenario> <rank> <world> <dir>

Each rank joins a gloo group through a ``FileStore`` under ``dir`` (no
fixed port that concurrent test workers could share), runs on the CPU with
one intra-op thread, reads its inputs from ``dir/inputs.npz`` (made by the
test from numpy, beside the reference's results) and writes what it found
to ``dir/rank<r>.json`` and ``dir/rank<r>_*.npy``.  It imports neither JAX
nor the reference package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Shard  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager, _unflatten  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import NATIVE_F32  # noqa: E402
from repro_torch.distributed import compress, pipeline  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    NamedSharding,
    decode_state_shardings,
    input_shardings,
    param_shardings,
    put,
    replicated,
    split_dim,
)
from repro_torch.launch.mesh import (  # noqa: E402
    init_distributed,
    make_local_mesh,
    make_mesh,
    make_production_mesh,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH = "qwen1.5-0.5b"
LR = 1e-3


def _model_and_state(inputs: dict, tcfg):
    cfg = get_smoke_config(ARCH).with_policy(NATIVE_F32)
    model = build_model(cfg, device="cpu")
    flat = {k[len("params/"):]: inputs[k] for k in inputs if k.startswith("params/")}
    params = params_from_jax(_unflatten(flat), device="cpu")
    state = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
    if tcfg.grad_compression:
        state["residual"] = tree.map_tree(torch.zeros_like, params)
    return cfg, model, state


def _batch(inputs: dict) -> dict:
    return {k: torch.from_numpy(inputs[k]) for k in ("tokens", "labels")}


def _replicas(state, mesh) -> dict:
    """Per leaf: this rank's coordinate on the mesh dims that shard it (its
    placements as text beside) and a hash of its local bytes: ranks whose
    coordinates agree hold replicas, which must hash alike."""
    out = {}
    coord = mesh.get_coordinate()
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = node

    walk(state, "")
    for path, x in flat.items():
        local = x.to_local() if isinstance(x, DTensor) else x
        shard_coord = ([c for c, p in zip(coord, x.placements) if isinstance(p, Shard)]
                       if isinstance(x, DTensor) else [])
        digest = hashlib.sha256(local.detach().contiguous().numpy().tobytes()).hexdigest()
        out[path] = {"key": f"{shard_coord}", "placements": str(getattr(x, "placements", None)),
                     "hash": digest}
    return out


def _grad_gap(model, tcfg, params, sharded_params, batch, mesh) -> float:
    """The largest gap between a leaf's sharded and unsharded gradient over
    the leaf's largest magnitude."""
    grad_fn = tstep.make_grad_fn(model, tcfg)
    want, _ = grad_fn(params, batch)
    with tstep.mesh_scope(mesh):
        got, _ = grad_fn(sharded_params, tstep.laid_out(batch, mesh))
        got = tstep.like_params(got, sharded_params)
    return max(float((g.full_tensor() - w).abs().max() / w.abs().max())
               for g, w in zip(tree.leaves(got), tree.leaves(want)))


def step_2x2(rank: int, inputs: dict, out: dict, d: str) -> None:
    """The qwen smoke train step unsharded and on a (2, 2) ('data',
    'model') mesh, two steps each, from the same state and batch; one step
    of a sequence-parallel arch each way."""
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(lr=LR, warmup_steps=0))
    cfg, model, state = _model_and_state(inputs, tcfg)
    batch = _batch(inputs)
    step = tstep.make_train_step(model, tcfg)
    s, losses = state, []
    for _ in range(2):
        s, m = step(s, batch)
        losses.append(float(m["loss"]))
    out["unsharded_losses"] = losses
    out["unsharded_grad_norm"] = float(m["grad_norm"])
    unsharded_params = s["params"]

    local = make_local_mesh("cpu")
    out["local_mesh"] = [list(local.mesh_dim_names), list(local.shape)]
    try:
        make_production_mesh(device="cpu")
    except ValueError as exc:
        out["production_refused"] = str(exc)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    sharded = put(state, tstep.state_shardings(state["params"], cfg, mesh, tcfg))
    sstep = tstep.make_train_step(model, tcfg, mesh)
    s, losses = sharded, []
    for _ in range(2):
        s, m = sstep(s, batch)
        losses.append(float(m["loss"]))
    out["sharded_losses"] = losses
    out["sharded_grad_norm"] = float(m["grad_norm"])
    out["metric_types"] = sorted({type(v).__name__ for v in m.values()})
    out["placements_kept"] = all(
        isinstance(b, DTensor) and tuple(a.placements) == tuple(b.placements)
        for a, b in zip(tree.leaves(sharded["params"]), tree.leaves(s["params"])))
    out["sharded_leaves"] = sum(
        any(isinstance(p, Shard) for p in x.placements) for x in tree.leaves(s["params"]))
    out["replicas"] = _replicas(s, mesh)
    out["param_gap"] = max(float((a - b.full_tensor()).abs().max())
                           for a, b in zip(tree.leaves(unsharded_params),
                                           tree.leaves(s["params"])))
    out["grad_gap"] = _grad_gap(model, tcfg, state["params"], sharded["params"], batch, mesh)

    # a sequence-parallel, FSDP arch (qwen1.5-4b: the sequence on 'model',
    # parameters also over 'data'): one step each way from the port's init
    sp_cfg = get_smoke_config("qwen1.5-4b").with_policy(NATIVE_F32)
    sp_model = build_model(sp_cfg, device="cpu")
    sp_params = sp_model.init(0)
    sp_state = {"params": sp_params, "opt": adamw.init_state(sp_params, tcfg.optimizer)}
    _, m = tstep.make_train_step(sp_model, tcfg)(sp_state, batch)
    out["sp_unsharded"] = [float(m["loss"]), float(m["grad_norm"])]
    sp_on = put(sp_state, tstep.state_shardings(sp_params, sp_cfg, mesh, tcfg))
    _, m = tstep.make_train_step(sp_model, tcfg, mesh)(sp_on, batch)
    out["sp_sharded"] = [float(m["loss"]), float(m["grad_norm"])]
    out["sp_grad_gap"] = _grad_gap(sp_model, tcfg, sp_params, sp_on["params"], batch, mesh)


def pod(rank: int, inputs: dict, out: dict, d: str) -> None:
    """Compression over a (2, 1, 2) ('pod', 'data', 'model') mesh, the
    pipeline over a (4,) stage axis, the elastic restore (4,) -> (2, 2)."""
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    p = mesh.get_coordinate()[0]
    # (a) replicated gradient: error and residual bounds
    g = torch.from_numpy(inputs["g_rep"])
    red, new_r = compress.compressed_psum_pod({"w": g}, {"w": torch.zeros_like(g)}, mesh)
    out["rep_err"] = float((red["w"] - g).abs().max())
    out["rep_bound"] = float(g.abs().max()) / 127.0
    out["rep_residual_gap"] = float((new_r["w"] - (g - red["w"])).abs().max())
    # (b) each pod its own gradient and residual: codes, mean, residual
    g, r = torch.from_numpy(inputs[f"g_pod{p}"]), torch.from_numpy(inputs[f"r_pod{p}"])
    q, s = compress._quantize_block(g + r)
    np.save(os.path.join(d, f"rank{rank}_codes.npy"), q.numpy())
    np.save(os.path.join(d, f"rank{rank}_scales.npy"), s.numpy())
    red, new_r = compress.compressed_psum_pod({"w": g}, {"w": r}, mesh)
    np.save(os.path.join(d, f"rank{rank}_reduced.npy"), red["w"].numpy())
    np.save(os.path.join(d, f"rank{rank}_residual.npy"), new_r["w"].numpy())
    # (c) what crosses 'pod' for a 4096-element leaf
    compress.reset_pod_traffic()
    compress.compressed_psum_pod({"w": torch.zeros(4096)}, {"w": torch.zeros(4096)}, mesh)
    out["traffic_4096"] = compress.pod_traffic()
    # (c') a (24, 40) leaf as a DTensor on the pod-free mesh, by rows, by
    # columns (blocks straddle the ranks) and replicated: each rank sends
    # its own share of the whole tensor's blocks
    sub = compress.pod_free(mesh)
    g2, r2 = (torch.from_numpy(inputs[f"{k}_pod{p}"]) for k in ("g2", "r2"))
    for name, spec in (("rows", (("model",), None)), ("cols", (None, ("model",))),
                       ("rep", ())):
        sh = NamedSharding(sub, spec)
        compress.reset_pod_traffic()
        red, new_r = compress.compressed_psum_pod({"w": sh.put(g2)}, {"w": sh.put(r2)}, mesh)
        out[f"g2_{name}_traffic"] = compress.pod_traffic()
        out[f"g2_{name}_placements"] = str(tuple(red["w"].placements))
        np.save(os.path.join(d, f"rank{rank}_g2_{name}_reduced.npy"),
                red["w"].full_tensor().numpy())
        np.save(os.path.join(d, f"rank{rank}_g2_{name}_residual.npy"),
                new_r["w"].full_tensor().numpy())

    # (d) the pipeline: S = 4 stages, M = 6 microbatches
    smesh = make_mesh((4,), ("pod",), "cpu")
    ws = torch.from_numpy(inputs["pipe_w"])
    xs = torch.from_numpy(inputs["pipe_x"])

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    w_plain = ws.clone().requires_grad_(True)
    y = pipeline.pipeline_apply(stage_fn, w_plain, xs, smesh, axis="pod")
    (gw,) = torch.autograd.grad(y.sum(), w_plain)
    dist.all_reduce(gw)  # each stage's rank holds its own slice's gradient
    w_sh = NamedSharding(smesh, (("pod",),)).put(ws).requires_grad_(True)
    y_sh = pipeline.pipeline_apply(stage_fn, w_sh, xs, smesh, axis="pod")
    (gw_sh,) = torch.autograd.grad(y_sh.sum(), w_sh)
    np.save(os.path.join(d, f"rank{rank}_pipe_out.npy"), y.detach().numpy())
    np.save(os.path.join(d, f"rank{rank}_pipe_out_sharded.npy"), y_sh.detach().numpy())
    np.save(os.path.join(d, f"rank{rank}_pipe_grad.npy"), gw.numpy())
    np.save(os.path.join(d, f"rank{rank}_pipe_grad_sharded.npy"), gw_sh.full_tensor().numpy())
    out["bubble_4_6"] = pipeline.bubble_fraction(4, 6)

    # (e) elastic restore: saved from a (4,) mesh, restored onto (2, 2)
    mgr = CheckpointManager(os.path.join(d, "port_ckpt"), async_save=False)
    m1 = make_mesh((4,), ("data",), "cpu")
    x = NamedSharding(m1, (("data",),)).put(torch.arange(64.0))
    mgr.save(1, {"x": x, "opt": {"step": replicated(m1).put(torch.tensor(1, dtype=torch.int32))}})
    m2 = make_mesh((2, 2), ("data", "model"), "cpu")
    want = {"x": NamedSharding(m2, (("model",),)), "opt": {"step": replicated(m2)}}
    step, st = mgr.restore(device="cpu", shardings=want)
    out["elastic_step"] = step
    out["elastic_equal"] = bool(torch.equal(st["x"].full_tensor(), torch.arange(64.0)))
    out["elastic_placements"] = str(tuple(st["x"].placements))
    out["elastic_local"] = st["x"].to_local().tolist()
    step, st = CheckpointManager(os.path.join(d, "ref_ckpt")).restore(device="cpu",
                                                                       shardings=want)
    out["ref_ckpt_step"] = step
    out["ref_ckpt_x"] = st["x"].full_tensor().tolist()
    out["ref_ckpt_placements"] = str(tuple(st["x"].placements))

    # (f) a grad_compression train step over (2, 1, 2): 3 steps, one batch
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(lr=LR, warmup_steps=0),
                             grad_compression=True)
    cfg, model, state = _model_and_state(inputs, tcfg)
    batch = _batch(inputs)
    state_on = put(state, tstep.state_shardings(state["params"], cfg, mesh, tcfg))
    sstep = tstep.make_train_step(model, tcfg, mesh)
    compress.reset_pod_traffic()
    losses = []
    for _ in range(3):
        state_on, m = sstep(state_on, batch)
        losses.append(float(m["loss"]))
    out["ef_losses"] = losses
    out["ef_traffic"] = compress.pod_traffic()
    out["ef_residual_max"] = max(float(x.full_tensor().abs().max())
                                 for x in tree.leaves(state_on["residual"]))
    out["ef_state_mesh"] = list(tstep.state_mesh(mesh, tcfg).mesh_dim_names)
    out["ef_replicas"] = _replicas(state_on["params"], tstep.state_mesh(mesh, tcfg))
    _, m = tstep.make_train_step(model, tcfg)(state, batch)  # no mesh: no compression
    out["unsharded_first_loss"] = float(m["loss"])


def _decode_gap(arch: str, mesh, kv_dtype: str, tokens: torch.Tensor) -> dict:
    """A prefill of ``tokens[:, :8]`` and decode steps of the rest, one token
    each, from the same parameters with a shared cache length: unsharded,
    and with parameters and decode state laid out on ``mesh`` by the
    reference's rules.  The largest logit gap over the logits' scale."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(arch).with_policy(NATIVE_F32),
                              kv_cache_dtype=kv_dtype)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    b = tokens.shape[0]
    chunks = [tokens[:, :8]] + [tokens[:, i:i + 1] for i in range(8, tokens.shape[1])]
    want, state = [], model.init_decode_state(b, 32)
    for t in chunks:
        logits, state = model.decode_step(params, t, state)
        want.append(logits)
    state = model.init_decode_state(b, 32)
    p_on = put(params, param_shardings(params, cfg, mesh))
    s_on = put(state, decode_state_shardings(state, cfg, mesh))
    got = []
    with tstep.mesh_scope(mesh):
        for t in chunks:
            logits, s_on = model.decode_step(p_on, put(t, input_shardings(t, mesh)), s_on)
            got.append(logits.full_tensor())
    kv = [n for layers in s_on.caches.values() for n in layers if hasattr(n, "k")]
    return {"gap": max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)),
            "steps": len(got),
            "kv_placements": sorted({str(tuple(n.k.placements)) for n in kv}),
            "kv_dtypes": sorted({str(n.k.dtype) for n in kv}),
            "scales": sum(n.k_scale is not None for n in kv)}


def shardwise(rank: int, inputs: dict, out: dict, d: str) -> None:
    """The shard-wise paths of a step over a (2, 2) ('data', 'model') mesh,
    each against the unsharded run on the same inputs: the microbatch split
    of a sharded batch, a step with two microbatches, split_dim's gather of
    a head count the model axis does not divide, cached decode steps (the
    KV writes and cached attention shard by shard, bf16 and int8 KV), and a
    train step of the state-space and hybrid archs (their einsums, the
    sequence pad of the causal conv, the RG-LRU's log-sigmoid)."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    batch = _batch(inputs)
    rows = batch["tokens"].shape[0] // 2

    # (a) microbatches of a sharded batch: the rows in order, each laid out
    # as the whole batch was
    on = tstep.laid_out(batch, mesh)
    parts = tstep._split_microbatches(on, 2)
    out["micro_rows"] = all(torch.equal(part[k].full_tensor(), batch[k][i * rows:(i + 1) * rows])
                            for i, part in enumerate(parts) for k in batch)
    out["micro_placements"] = all(tuple(part[k].placements) == tuple(on[k].placements)
                                  for part in parts for k in batch)

    # (b) a step of two microbatches, data-parallel and sequence-parallel
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(lr=LR, warmup_steps=0),
                             accum_steps=2)
    for arch in ("qwen1.5-0.5b", "qwen1.5-4b", "mamba2-2.7b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch).with_policy(NATIVE_F32)
        model = build_model(cfg, device="cpu")
        params = model.init(0)
        t = tcfg if arch.startswith("qwen") else dataclasses.replace(tcfg, accum_steps=1)
        state = {"params": params, "opt": adamw.init_state(params, t.optimizer)}
        _, m = tstep.make_train_step(model, t)(state, batch)
        state_on = put(state, tstep.state_shardings(params, cfg, mesh, t))
        _, ms = tstep.make_train_step(model, t, mesh)(state_on, batch)
        out[f"step_{arch}"] = {
            "accum_steps": t.accum_steps,
            "loss": [float(m["loss"]), float(ms["loss"])],
            "grad_norm": [float(m["grad_norm"]), float(ms["grad_norm"])],
            "grad_gap": _grad_gap(model, t, params, state_on["params"], batch, mesh)}

    # (c) split_dim: 2 heads of a dim sharded 4 ways are gathered first
    line = make_mesh((4,), ("model",), "cpu")
    x = torch.from_numpy(inputs["split_x"])
    xs = NamedSharding(line, (None, ("model",))).put(x)
    y = split_dim(xs, -1, 2, x.shape[1] // 2)
    out["split_equal"] = bool(torch.equal(y.full_tensor(), x.reshape(x.shape[0], 2, -1)))
    y = split_dim(xs, -1, 4, x.shape[1] // 4)  # 4 heads: split shard by shard
    out["split4_equal"] = bool(torch.equal(y.full_tensor(), x.reshape(x.shape[0], 4, -1)))
    out["split4_placements"] = str(tuple(y.placements))

    # (d) cached decode, shared length: bf16 and int8 KV, and the hybrid's
    # local-window cache and recurrent states
    tokens = batch["tokens"][:4, :12]
    out["decode_qwen_bf16"] = _decode_gap("qwen1.5-0.5b", mesh, "bfloat16", tokens)
    out["decode_qwen_int8"] = _decode_gap("qwen1.5-0.5b", mesh, "int8", tokens)
    out["decode_rg_bf16"] = _decode_gap("recurrentgemma-9b", mesh, "bfloat16", tokens)


SCENARIOS = {"step_2x2": step_2x2, "pod": pod, "shardwise": shardwise}


def main() -> None:
    scenario, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{os.path.join(d, 'store')}", rank=rank,
                     world_size=world)
    with np.load(os.path.join(d, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    out: dict = {}
    try:
        SCENARIOS[scenario](rank, inputs, out, d)
    finally:
        with open(os.path.join(d, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
