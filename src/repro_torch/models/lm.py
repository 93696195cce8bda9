"""The language model, dense family (``qwen1.5-0.5b`` and its smoke size).

Functional style like the reference: ``init(seed) -> params`` (a nested dict
of tensors), ``apply(params, batch)`` for the full-sequence forward,
``decode_step`` for serving (a multi-token call is the prefill).  Where the
reference scans a stacked layer axis, this is a Python loop over the layers:
parameters keep the stacked layout — ``params["layers"]["seg0_dense"]``
leaves carry a leading layer axis and weights are ``(d_in, d_out)`` — and
layer ``i`` reads the view ``leaf[i]``.  Decode caches are a list with one
``KVCache`` per layer.  The other families (moe / ssm / hybrid / encdec /
vlm) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    KVCache,
    Params,
    attention_apply,
    attention_init,
    dense_init,
    kv_cache_init,
    pein,
    rms_norm,
    swiglu_apply,
    swiglu_init,
)

Tensor = torch.Tensor

_SEG = "seg0_dense"


@dataclasses.dataclass
class DecodeState:
    caches: Any  # {"seg0_dense": [KVCache per layer]}
    position: Tensor  # scalar int32; (B,) int32 in per-slot (serving) layout
    enc_out: Tensor | None = None  # encdec only (not ported)


def map_state(fn, *states: DecodeState) -> DecodeState:
    """Apply ``fn(leaf, ...)`` to every tensor leaf of DecodeStates of the
    same structure (``None`` leaves stay ``None``)."""
    first = states[0]

    def leaf(*xs):
        return None if xs[0] is None else fn(*xs)

    caches = {}
    for key, layers in first.caches.items():
        out = []
        for li in range(len(layers)):
            nodes = [s.caches[key][li] for s in states]
            out.append(KVCache(*[
                leaf(*[getattr(n, f.name) for n in nodes])
                for f in dataclasses.fields(KVCache)]))
        caches[key] = out
    return DecodeState(
        caches=caches,
        position=leaf(*[s.position for s in states]),
        enc_out=leaf(*[s.enc_out for s in states]),
    )


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def _block_apply(p: Params, x: Tensor, cfg: ArchConfig, *, positions=None, cache=None):
    """One dense block.  Returns (x, new_cache)."""
    h, new_cache = attention_apply(
        p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
        positions=positions, cache=cache,
    )
    x = x + h
    h = swiglu_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg.policy)
    return x + h, new_cache


class LanguageModel:
    """cfg-driven functional model (dense family)."""

    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet (ROADMAP "
                f"Queue A item 11, 'Remaining model families')")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = ["dense"] * cfg.n_layers
        self.segments: list[tuple[str, int]] = [("dense", cfg.n_layers)]

    def with_policy(self, policy) -> "LanguageModel":
        return LanguageModel(self.cfg.with_policy(policy), device=self.device)

    # -- init ---------------------------------------------------------------

    def init(self, seed: int | torch.Generator = 0) -> Params:
        """Random parameters from a seed, made on the model's device.  (The
        numbers differ from the reference's ``init(key)``; tests hand both
        packages the same numpy arrays through ``convert.params_from_jax``.)"""
        cfg = self.cfg
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        dev = gen.device
        n = cfg.n_layers

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        params: Params = {
            "embed": {"w": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                       device=dev, dtype=torch.float32) * 0.02},
            "final_norm": zeros(cfg.d_model),
            "layers": {_SEG: {
                "norm1": zeros(n, cfg.d_model),
                "attn": attention_init(gen, cfg, layers=n),
                "norm2": zeros(n, cfg.d_model),
                "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, layers=n),
            }},
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02)
        return params

    # -- shared helpers -------------------------------------------------------

    def _embed(self, params: Params, tokens: Tensor) -> Tensor:
        return params["embed"]["w"][tokens.long()].to(torch.float32)  # gather

    def _logits(self, params: Params, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            return pein("bsd,vd->bsv", x, params["embed"]["w"], "logits", cfg.policy)
        return pein("bsd,dv->bsv", x, params["unembed"]["w"], "logits", cfg.policy)

    def _stack(self, seg_params, x, *, caches=None, positions=None):
        """Python loop over the stacked layer axis.  Returns (x, new_caches)."""
        new_caches = []
        for i in range(self.cfg.n_layers):
            x, nc = _block_apply(
                layer_params(seg_params, i), x, self.cfg, positions=positions,
                cache=None if caches is None else caches[i])
            new_caches.append(nc)
        return x, (None if caches is None else new_caches)

    # -- full-sequence forward ------------------------------------------------

    @torch.no_grad()
    def apply(self, params: Params, batch: dict[str, Tensor]) -> tuple[Tensor, Tensor]:
        """Returns (logits, aux_loss); aux is 0 for the dense family."""
        tokens = batch["tokens"].to(self.device)
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._stack(params["layers"][_SEG], x, positions=positions)
        return self._logits(params, x), torch.zeros((), device=x.device)

    # -- serving ----------------------------------------------------------------

    def init_decode_state(self, batch: int, max_len: int, enc_len: int = 0,
                          per_slot: bool = False) -> DecodeState:
        """``per_slot=True`` builds the continuous-batching layout: every KV
        cache carries (B,) lengths / (B, Smax) positions and ``position`` is
        (B,), so slots at different sequence depths share one decode step."""
        cfg = self.cfg
        dev = self.device
        caches = {_SEG: [
            kv_cache_init(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                          cfg.kv_cache_dtype, per_slot=per_slot, device=dev)
            for _ in range(cfg.n_layers)]}
        position = (torch.zeros((batch,), dtype=torch.int32, device=dev) if per_slot
                    else torch.zeros((), dtype=torch.int32, device=dev))
        return DecodeState(caches=caches, position=position, enc_out=None)

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: Tensor,
                    state: DecodeState) -> tuple[Tensor, DecodeState]:
        """tokens: (B, S_step) — one (or a few) new token(s) per sequence.
        ``state`` is not modified; the new state is returned."""
        tokens = tokens.to(self.device)
        x = self._embed(params, tokens)
        # per-slot layout: position (B,) -> positions (B, S); shared: (S,)
        pos0 = state.position
        positions = (pos0[:, None] if pos0.dim() else pos0) + torch.arange(
            x.shape[1], device=x.device)
        x, nc = self._stack(params["layers"][_SEG], x, caches=state.caches[_SEG],
                            positions=positions)
        logits = self._logits(params, x)
        new_state = DecodeState(
            caches={_SEG: nc},
            position=(state.position + tokens.shape[1]).to(torch.int32),
            enc_out=state.enc_out,
        )
        return logits, new_state


def build_model(cfg: ArchConfig, device=None) -> LanguageModel:
    """``device=None`` means the GPU and raises when there is none."""
    return LanguageModel(cfg, device=device)
