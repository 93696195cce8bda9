"""The language model: every family of the reference — ``dense``, ``moe``
(capacity-routed experts, optionally after leading dense layers),
``ssm`` (Mamba-2), ``hybrid`` (RecurrentGemma: RG-LRU + local attention),
``encdec`` (Whisper: an encoder stack, decoder blocks with cross-attention)
and ``vlm`` (InternVL2: patch embeddings prepended to the text).

Functional style like the reference: ``init(seed) -> params`` (a nested dict
of tensors), ``apply(params, batch)`` for the full-sequence forward,
``decode_step`` for serving (a multi-token call is the prefill).  Where the
reference scans a stacked layer axis, this is a Python loop over the layers:
parameters keep the stacked layout — ``params["layers"]["seg0_dense"]``
(``"seg0_ssm"``, ``"seg0_moe"``, ``"seg0_dec"``; Kimi-K2's leading dense
layer makes ``"seg0_dense"`` then ``"seg1_moe"``) and the encoder's
``params["enc_layers"]`` leaves carry a leading layer axis, the hybrid's
repeating ``(rec, rec, attn_local)`` supergroup is ``params["super"]`` with
its leaves stacked over the supergroups and the remainder layers
``params["rem"]`` unstacked, as in the reference — and weights are
``(d_in, d_out)``; layer ``i`` reads the view ``leaf[i]``.

Decode caches are a dict of lists with one node per layer, so every batch
axis is 0: ``KVCache`` (or ``PagedKVCache``, built by the paged serving
layout) for attention (self-attention only: cross-attention reads
``DecodeState.enc_out``, set by ``prefill_encoder``), ``SSMState`` for a
Mamba-2 block, ``RGLRUState`` for a recurrent block.  The hybrid's keys
name the stack and the pattern slot
(``"super/l0_rec"``, ``"super/l2_attn_local"``, ``"rem/l0_rec"``); its
local-attention caches hold ``min(max_len, local_window)`` rows, a ring.
``apply`` returns the MoE layers' summed auxiliary loss; ``decode_step``
drops it, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import griffin as griffin_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    Params,
    attention_apply,
    attention_init,
    dense_init,
    gelu_mlp_apply,
    gelu_mlp_init,
    kv_cache_init,
    pein,
    rms_norm,
    swiglu_apply,
    swiglu_init,
)

Tensor = torch.Tensor

@dataclasses.dataclass
class DecodeState:
    caches: Any  # {cache key: [one KVCache / PagedKVCache / SSMState / RGLRUState per layer]}
    position: Tensor  # scalar int32; (B,) int32 in per-slot (serving) layout
    enc_out: Tensor | None = None  # encdec: the encoder's output (prefill_encoder)


def map_state(fn, *states: DecodeState) -> DecodeState:
    """Apply ``fn(leaf, ...)`` to every tensor leaf of DecodeStates of the
    same structure (``None`` leaves stay ``None``); cache nodes of every
    kind (``KVCache``, ``PagedKVCache``, ``SSMState``, ``RGLRUState``) keep
    their type."""
    first = states[0]

    def leaf(*xs):
        return None if xs[0] is None else fn(*xs)

    caches = {}
    for key, layers in first.caches.items():
        out = []
        for li, node in enumerate(layers):
            nodes = [s.caches[key][li] for s in states]
            out.append(type(node)(*[
                leaf(*[getattr(n, f.name) for n in nodes])
                for f in dataclasses.fields(node)]))
        caches[key] = out
    return DecodeState(
        caches=caches,
        position=leaf(*[s.position for s in states]),
        enc_out=leaf(*[s.enc_out for s in states]),
    )


def state_leaves(state: DecodeState) -> list[Tensor]:
    """Every tensor leaf of a DecodeState, in ``map_state``'s order."""
    leaves = [getattr(node, f.name) for layers in state.caches.values()
              for node in layers for f in dataclasses.fields(node)]
    leaves += [state.position, state.enc_out]
    return [x for x in leaves if x is not None]


def copy_state_(dst: DecodeState, src: DecodeState) -> None:
    """Write every leaf of ``src`` into the tensors of ``dst`` (same
    structure), in place: ``dst``'s buffers outlive the call, as the static
    state of a captured step must.  A leaf that already IS ``dst``'s tensor
    is skipped: the paged pools and page tables, which a step writes in
    place or not at all (a self-copy of a pool would move gigabytes)."""
    for d, s in zip(state_leaves(dst), state_leaves(src), strict=True):
        if d is not s:
            d.copy_(s)


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def _block_init(gen: torch.Generator, cfg: ArchConfig, kind: str,
                layers: int | None) -> Params:
    """One block of ``kind`` (``layers=L``: L blocks stacked on a leading
    axis), the reference's ``_block_init`` tree."""
    lead = () if layers is None else (layers,)

    def norm():
        return torch.zeros((*lead, cfg.d_model), dtype=torch.float32, device=gen.device)

    p: Params = {"norm1": norm()}
    if kind in ("dense", "moe", "enc", "dec", "attn_local"):
        p["attn"] = attention_init(gen, cfg, layers=layers)
        p["norm2"] = norm()
        if kind == "moe":
            p["moe"] = moe_lib.moe_init(gen, cfg, layers=layers)
        elif kind in ("enc", "dec"):
            p["mlp"] = gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, layers=layers)
        else:
            p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, layers=layers)
        if kind == "dec":
            p["cross"] = attention_init(gen, cfg, layers=layers)
            p["norm3"] = norm()
    elif kind == "ssm":
        p["ssm"] = ssm_lib.mamba2_init(gen, cfg, layers=layers)
    elif kind == "rec":
        p["rec"] = griffin_lib.rglru_init(gen, cfg, layers=layers)
        p["norm2"] = norm()
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, layers=layers)
    else:
        raise ValueError(kind)
    return p


def _block_apply(p: Params, x: Tensor, cfg: ArchConfig, kind: str, *, positions=None,
                 cache=None, enc_out: Tensor | None = None, write_pools: bool = True):
    """One block of ``kind``.  Returns (x, new_cache, aux): ``aux`` is a MoE
    block's load-balance loss, None for the other kinds."""
    if kind in ("dense", "moe", "enc", "dec", "attn_local"):
        h, new_cache = attention_apply(
            p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
            positions=positions, cache=cache,
            window=cfg.local_window if kind == "attn_local" else 0,
            causal=kind != "enc", write_pools=write_pools,
        )
        x = x + h
        if kind == "dec":
            h, _ = attention_apply(p["cross"], rms_norm(x, p["norm3"], cfg.norm_eps), cfg,
                                   kv_override=(enc_out, enc_out))
            x = x + h
        xi = rms_norm(x, p["norm2"], cfg.norm_eps)
        aux = None
        if kind == "moe":
            h, aux = moe_lib.moe_apply(p["moe"], xi, cfg)
        elif kind in ("enc", "dec"):
            h = gelu_mlp_apply(p["mlp"], xi, cfg.policy)
        else:
            h = swiglu_apply(p["mlp"], xi, cfg.policy)
        return x + h, new_cache, aux
    if kind == "ssm":
        h, new_state = ssm_lib.mamba2_apply(
            p["ssm"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, state=cache)
        return x + h, new_state, None
    if kind == "rec":
        h, new_state = griffin_lib.rglru_block_apply(
            p["rec"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, state=cache)
        x = x + h
        h = swiglu_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg.policy)
        return x + h, new_state, None
    raise ValueError(kind)


def _layer_kinds(cfg: ArchConfig) -> list[str]:
    if cfg.family in ("dense", "vlm"):
        return ["dense"] * cfg.n_layers
    if cfg.family == "moe":
        return ["dense"] * cfg.moe_first_dense + ["moe"] * (cfg.n_layers - cfg.moe_first_dense)
    if cfg.family == "encdec":
        return ["dec"] * cfg.n_layers
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.hybrid_pattern or ("rec", "rec", "attn_local")
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    raise ValueError(cfg.family)


@dataclasses.dataclass(frozen=True)
class _Layer:
    """Where one layer lives: its kind, its parameters
    (``params[top][key]``, layer ``index`` of a stacked tree or the whole
    tree when ``index`` is None) and its cache (``caches[cache_key][node]``)."""

    kind: str
    top: str
    key: str
    index: int | None
    cache_key: str
    node: int


class LanguageModel:
    """cfg-driven functional model covering every family."""

    def __init__(self, cfg: ArchConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = _layer_kinds(cfg)
        # contiguous runs of identical layer kinds share one stacked tree
        self.segments: list[tuple[str, int]] = []
        for kd in self.kinds:
            if self.segments and self.segments[-1][0] == kd:
                self.segments[-1] = (kd, self.segments[-1][1] + 1)
            else:
                self.segments.append((kd, 1))
        if cfg.family == "hybrid":
            # the repeating supergroup, stacked, then the remainder layers
            pat = cfg.hybrid_pattern or ("rec", "rec", "attn_local")
            n_super, rem = divmod(cfg.n_layers, len(pat))
            self.hybrid_pat = tuple(pat)
            self.n_super = n_super
            self.hybrid_rem = [pat[i] for i in range(rem)]
            self.layers = [
                _Layer(kd, "super", f"l{i}_{kd}", g, f"super/l{i}_{kd}", g)
                for g in range(n_super) for i, kd in enumerate(pat)]
            self.layers += [_Layer(kd, "rem", f"l{i}_{kd}", None, f"rem/l{i}_{kd}", 0)
                            for i, kd in enumerate(self.hybrid_rem)]
        else:
            self.layers = [
                _Layer(kd, "layers", f"seg{si}_{kd}", i, f"seg{si}_{kd}", i)
                for si, (kd, n) in enumerate(self.segments) for i in range(n)]

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
        params: Params = {
            "embed": {"w": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                       device=dev, dtype=torch.float32) * 0.02},
            "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        }
        if cfg.family == "hybrid":
            params["super"] = {f"l{i}_{kd}": _block_init(gen, cfg, kd, self.n_super)
                               for i, kd in enumerate(self.hybrid_pat)}
            if self.hybrid_rem:
                params["rem"] = {f"l{i}_{kd}": _block_init(gen, cfg, kd, None)
                                 for i, kd in enumerate(self.hybrid_rem)}
        else:
            params["layers"] = {f"seg{si}_{kd}": _block_init(gen, cfg, kd, n)
                                for si, (kd, n) in enumerate(self.segments)}
        if cfg.family == "encdec":
            params["enc_layers"] = _block_init(gen, cfg, "enc", cfg.n_encoder_layers)
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

    def _stack(self, params: Params, x, *, caches=None, positions=None, enc_out=None,
               write_pools=True):
        """Python loop over the layers in the reference's order (for the
        hybrid: every supergroup's pattern, then the remainder).  Returns
        (x, new_caches, aux): the MoE layers' summed loss."""
        new_caches = (None if caches is None
                      else {key: list(nodes) for key, nodes in caches.items()})
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for ly in self.layers:
            tree = params[ly.top][ly.key]
            p = tree if ly.index is None else layer_params(tree, ly.index)
            x, nc, a = _block_apply(
                p, x, self.cfg, ly.kind, positions=positions,
                cache=None if caches is None else caches[ly.cache_key][ly.node],
                enc_out=enc_out, write_pools=write_pools)
            if a is not None:
                aux = aux + a
            if caches is not None:
                new_caches[ly.cache_key][ly.node] = nc
        return x, new_caches, aux

    def _encode(self, params: Params, frames: Tensor) -> Tensor:
        """The enc-dec family's encoder over (B, S_enc, D) frame embeddings:
        the non-causal ``enc`` stack, then the final norm the decoder's
        logits share (the reference's ``prefill_encoder``)."""
        cfg = self.cfg
        x = frames.to(device=self.device, dtype=torch.float32)
        positions = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.n_encoder_layers):
            x, _, _ = _block_apply(layer_params(params["enc_layers"], i), x, cfg, "enc",
                                   positions=positions)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    # -- full-sequence forward ------------------------------------------------

    @torch.no_grad()
    def apply(self, params: Params, batch: dict[str, Tensor]) -> tuple[Tensor, Tensor]:
        """Returns (logits, aux_loss): the MoE layers' summed load-balance
        loss (0 for the other families).  ``batch``: ``tokens``, and
        ``frames`` (enc-dec: the encoder's input embeddings) or
        ``pixel_embeds`` (VLM: patch embeddings prepended to the text, whose
        rows are dropped from the logits)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        x = self._embed(params, tokens)
        enc_out = self._encode(params, batch["frames"]) if cfg.family == "encdec" else None
        n_pix = 0
        if cfg.family == "vlm":
            pix = batch["pixel_embeds"].to(device=self.device, dtype=torch.float32)
            n_pix = pix.shape[1]
            x = torch.cat([pix, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = self._stack(params, x, positions=positions, enc_out=enc_out)
        return self._logits(params, x[:, n_pix:]), aux

    # -- serving ----------------------------------------------------------------

    def init_decode_state(self, batch: int, max_len: int, enc_len: int = 0,
                          per_slot: bool = False) -> DecodeState:
        """``per_slot=True`` builds the continuous-batching layout: every KV
        cache carries (B,) lengths / (B, Smax) positions and ``position`` is
        (B,), so slots at different sequence depths share one decode step.
        Recurrent states (``SSMState``, ``RGLRUState``) are per-row in either
        layout; a local-attention cache holds ``min(max_len, local_window)``
        rows."""
        cfg = self.cfg
        dev = self.device

        def node(kind):
            if kind in ("dense", "moe", "dec", "attn_local"):
                cap = max_len
                if kind == "attn_local":
                    cap = min(max_len, cfg.local_window or max_len)
                return kv_cache_init(batch, cap, cfg.n_kv_heads, cfg.head_dim,
                                     cfg.kv_cache_dtype, per_slot=per_slot, device=dev)
            if kind == "ssm":
                return ssm_lib.ssm_state_init(cfg, batch, device=dev)
            return griffin_lib.rglru_state_init(cfg, batch, device=dev)

        caches: dict[str, list] = {}
        for ly in self.layers:
            caches.setdefault(ly.cache_key, []).append(node(ly.kind))
        position = (torch.zeros((batch,), dtype=torch.int32, device=dev) if per_slot
                    else torch.zeros((), dtype=torch.int32, device=dev))
        return DecodeState(caches=caches, position=position, enc_out=None)

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: Tensor, state: DecodeState,
                    pixel_embeds: Tensor | None = None,
                    write_pools: bool = True) -> tuple[Tensor, DecodeState]:
        """tokens: (B, S_step) — one (or a few) new token(s) per sequence.
        ``pixel_embeds`` (VLM prefill): (B, n_patches, D) patch embeddings
        prepended to the prompt; the position advances past both, and the
        logits keep only the text rows.  An enc-dec state carries the
        encoder's output (``prefill_encoder``) for the cross-attention.
        The new state is returned.  A dense ``state`` is not modified; the
        pools of a paged state (``PagedKVCache`` nodes, shared by every row)
        receive the new K/V in place, unless ``write_pools=False``."""
        tokens = tokens.to(self.device)
        x = self._embed(params, tokens)
        n_pix = 0
        if pixel_embeds is not None:
            n_pix = pixel_embeds.shape[1]
            x = torch.cat([pixel_embeds.to(device=self.device, dtype=torch.float32), x], dim=1)
        # per-slot layout: position (B,) -> positions (B, S); shared: (S,)
        pos0 = state.position
        positions = (pos0[:, None] if pos0.dim() else pos0) + torch.arange(
            x.shape[1], device=x.device)
        x, nc, _ = self._stack(params, x, caches=state.caches, positions=positions,
                               enc_out=state.enc_out, write_pools=write_pools)
        logits = self._logits(params, x[:, n_pix:])
        new_state = DecodeState(
            caches=nc,
            position=(state.position + x.shape[1]).to(torch.int32),
            enc_out=state.enc_out,
        )
        return logits, new_state

    @torch.no_grad()
    def prefill_encoder(self, params: Params, frames: Tensor,
                        state: DecodeState) -> DecodeState:
        """The enc-dec family: run the encoder over ``frames`` (B, S_enc, D)
        and return ``state`` carrying its output for ``decode_step``."""
        return dataclasses.replace(state, enc_out=self._encode(params, frames))


def build_model(cfg: ArchConfig, device=None) -> LanguageModel:
    """``device=None`` means the GPU and raises when there is none."""
    return LanguageModel(cfg, device=device)
