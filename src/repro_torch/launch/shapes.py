"""The assigned (architecture x input-shape) cells and their step builders.

The reference's ``repro.launch.shapes`` (``src/repro/launch/shapes.py``).
Shapes (LM family):
    train_4k      seq=4096    global_batch=256   (training step)
    prefill_32k   seq=32768   global_batch=32    (inference prefill)
    decode_32k    seq=32768   global_batch=128   (one token, 32k KV cache)
    long_500k     seq=524288  global_batch=1     (long-context decode —
                  sub-quadratic archs only: ssm / hybrid; full-attention
                  archs are N/A by definition)

Stand-ins are meta tensors (``input_specs``) or fake tensors
(``torch._subclasses.FakeTensorMode``: ``build_cell`` makes the model's
parameters and states under one): no device allocation anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree
from repro_torch.distributed.sharding import (
    decode_state_shardings,
    input_shardings,
    param_shardings,
)
from repro_torch.models import build_model
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step, state_shardings


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# gradient-accumulation steps per arch for train_4k (activation-memory lever)
ACCUM = {
    "kimi-k2-1t-a32b": 16,
    "command-r-plus-104b": 8,
    "phi3.5-moe-42b-a6.6b": 8,
    "recurrentgemma-9b": 4,
    "qwen1.5-4b": 4,
    "phi3-mini-3.8b": 4,
    "mamba2-2.7b": 2,
    "whisper-medium": 2,
    "qwen1.5-0.5b": 2,
    "internvl2-1b": 2,
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: no sub-quadratic path (DESIGN.md)"
    return True, ""


def _arch_tweaks(cfg: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """Per-cell execution knobs (documented levers, not architecture changes)."""
    changes: dict = {}
    if cfg.name == "kimi-k2-1t-a32b":
        # int8 moments: 1T-param AdamW does not fit 512 devices otherwise
        changes["moe_group_size"] = 512
    if shape.kind != "train" and shape.seq >= 32768:
        changes["attn_chunk"] = 2048
    return dataclasses.replace(cfg, **changes) if changes else cfg


def _spec(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, device="meta") -> dict[str, torch.Tensor]:
    """Stand-ins for the *data* inputs of the step: meta tensors by default
    (under a ``FakeTensorMode``, pass the fake device)."""
    b, s = shape.batch, shape.seq
    i32, f32 = torch.int32, torch.float32

    def t(shp, dt):
        return _spec(shp, dt, device)

    if shape.kind == "train":
        if cfg.family == "encdec":
            return {"frames": t((b, s, cfg.d_model), f32), "tokens": t((b, s), i32),
                    "labels": t((b, s), i32)}
        if cfg.family == "vlm":
            st = s - cfg.n_vision_tokens
            return {"tokens": t((b, st), i32),
                    "pixel_embeds": t((b, cfg.n_vision_tokens, cfg.d_model), f32),
                    "labels": t((b, st), i32)}
        return {"tokens": t((b, s), i32), "labels": t((b, s), i32)}
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": t((b, s, cfg.d_model), f32), "tokens": t((b, s), i32)}
        if cfg.family == "vlm":
            return {"tokens": t((b, s - cfg.n_vision_tokens), i32),
                    "pixel_embeds": t((b, cfg.n_vision_tokens, cfg.d_model), f32)}
        return {"tokens": t((b, s), i32)}
    # decode: one new token against a seq-length cache
    return {"tokens": t((b, 1), i32)}


def param_specs(cfg: ArchConfig) -> Any:
    """The parameters' shapes and dtypes as meta tensors (the reference's
    ``jax.eval_shape(model.init, key)``): ``model.init`` run under a fake
    mode, each leaf then made again on the meta device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = build_model(cfg, device="cpu").init(0)
    return tree.map_tree(lambda x: _spec(tuple(x.shape), x.dtype, "meta"), params)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *, grad_compression: bool = False,
               fake_mode=None) -> dict:
    """Returns dict(fn, args, in_shardings, out_shardings, donate, model, cfg,
    tcfg, fake_mode) — the (architecture x shape x mesh) dry-run unit.
    ``args`` are fake tensors of ``fake_mode`` (a new ``FakeTensorMode``
    when None), whole tensors on the mesh's device type; ``in_shardings``
    are the port's ``NamedSharding``s, and ``put`` under ``fake_mode`` lays
    them out as the step takes them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_mode = fake_mode or FakeTensorMode()
    cfg = _arch_tweaks(cfg, shape)
    dev = "cpu" if mesh.device_type == "cpu" else mesh.device_type
    with fake_mode:
        model = build_model(cfg, device=dev)
        data = input_specs(cfg, shape, device=dev)
        params = model.init(0)
        out = _train_cell(model, cfg, shape, mesh, data, params, grad_compression) \
            if shape.kind == "train" else _serve_cell(model, cfg, shape, mesh, data, params)
    out.update(model=model, cfg=cfg, fake_mode=fake_mode)
    return out


def _train_cell(model, cfg, shape, mesh, data, params, grad_compression) -> dict:
    quant_moments = cfg.name == "kimi-k2-1t-a32b"
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(quantize_moments=quant_moments),
        accum_steps=ACCUM.get(cfg.name, 1),
        grad_compression=grad_compression,
    )
    step = make_train_step(model, tcfg, mesh)
    state = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
    if grad_compression:
        state["residual"] = tree.map_tree(torch.zeros_like, params)
    state_shard = state_shardings(params, cfg, mesh, tcfg)
    return {
        "fn": step,
        "args": (state, data),
        "in_shardings": (state_shard, input_shardings(data, mesh)),
        "out_shardings": (state_shard, None),
        "donate": (0,),
        "tcfg": tcfg,
    }


def _serve_cell(model, cfg, shape, mesh, data, params) -> dict:
    b, s = shape.batch, shape.seq
    p_shard = param_shardings(params, cfg, mesh)
    state = model.init_decode_state(b, s)
    if cfg.family == "encdec":
        state = dataclasses.replace(
            state, enc_out=torch.empty((b, s, cfg.d_model), dtype=torch.float32,
                                       device=model.device))
    s_shard = decode_state_shardings(state, cfg, mesh)
    if shape.kind == "prefill" and cfg.family == "encdec":

        def fn(params, frames, tokens, state):
            state = model.prefill_encoder(params, frames, state)
            return model.decode_step(params, tokens, state)

        args = (params, data["frames"], data["tokens"], state)
        insh = (p_shard, input_shardings(data["frames"], mesh),
                input_shardings(data["tokens"], mesh), s_shard)
        donate = (3,)
    elif shape.kind == "prefill" and cfg.family == "vlm":

        def fn(params, tokens, pixel_embeds, state):
            return model.decode_step(params, tokens, state, pixel_embeds=pixel_embeds)

        args = (params, data["tokens"], data["pixel_embeds"], state)
        insh = (p_shard, input_shardings(data["tokens"], mesh),
                input_shardings(data["pixel_embeds"], mesh), s_shard)
        donate = (3,)
    else:  # prefill of the other families, and decode (a seq-length cache)

        def fn(params, tokens, state):
            return model.decode_step(params, tokens, state)

        args = (params, data["tokens"], state)
        insh = (p_shard, input_shardings(data["tokens"], mesh), s_shard)
        donate = (2,)
    return {"fn": fn, "args": args, "in_shardings": insh,
            "out_shardings": (None, s_shard), "donate": donate, "tcfg": None}


def _tree_paths(t, prefix=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _tree_paths(v, f"{prefix}.{k}" if prefix else str(k))
    else:
        yield prefix, t


def count_params(params_shape, cfg: ArchConfig) -> dict:
    """Total and active (MoE) parameter counts from shapes (no allocation)."""
    total = active = embed = 0
    for path, leaf in _tree_paths(params_shape):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        if "embed" in path or "unembed" in path:
            embed += n
        if cfg.moe_experts and any(s in path for s in ("moe.gate", "moe.up", "moe.down")):
            active += n * cfg.moe_top_k // cfg.moe_experts
        else:
            active += n
    return {"total": total, "active": active, "embed": embed}


def model_flops(cfg: ArchConfig, shape: ShapeSpec, params_shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active non-embed."""
    counts = count_params(params_shape, cfg)
    n = counts["active"] - counts["embed"]
    # unembed/logits matmul is real compute: add vocab head explicitly
    n_head = cfg.vocab * cfg.d_model
    if shape.kind == "train":
        return 6.0 * (n + n_head) * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * (n + n_head) * shape.batch * shape.seq
    return 2.0 * (n + n_head) * shape.batch  # one step
