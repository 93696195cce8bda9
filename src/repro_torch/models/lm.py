"""The language model: the dense, ``ssm`` (Mamba-2) and ``hybrid``
(RecurrentGemma: RG-LRU + local attention) families.

Functional style like the reference: ``init(seed) -> params`` (a nested dict
of tensors), ``apply(params, batch)`` for the full-sequence forward,
``decode_step`` for serving (a multi-token call is the prefill).  Where the
reference scans a stacked layer axis, this is a Python loop over the layers:
parameters keep the stacked layout — ``params["layers"]["seg0_dense"]``
(or ``"seg0_ssm"``) leaves carry a leading layer axis, the hybrid's
repeating ``(rec, rec, attn_local)`` supergroup is ``params["super"]`` with
its leaves stacked over the supergroups and the remainder layers
``params["rem"]`` unstacked, as in the reference — and weights are
``(d_in, d_out)``; layer ``i`` reads the view ``leaf[i]``.

Decode caches are a dict of lists with one node per layer, so every batch
axis is 0: ``KVCache`` (or ``PagedKVCache``, built by the paged serving
layout) for attention, ``SSMState`` for a Mamba-2 block, ``RGLRUState`` for
a recurrent block.  The hybrid's keys name the stack and the pattern slot
(``"super/l0_rec"``, ``"super/l2_attn_local"``, ``"rem/l0_rec"``); its
local-attention caches hold ``min(max_len, local_window)`` rows, a ring.
The moe / encdec / vlm families are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import griffin as griffin_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
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

#: the families whose blocks are ported
PORTED_FAMILIES = ("dense", "ssm", "hybrid")


@dataclasses.dataclass
class DecodeState:
    caches: Any  # {cache key: [one KVCache / PagedKVCache / SSMState / RGLRUState per layer]}
    position: Tensor  # scalar int32; (B,) int32 in per-slot (serving) layout
    enc_out: Tensor | None = None  # encdec only (not ported)


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
    if kind in ("dense", "attn_local"):
        p["attn"] = attention_init(gen, cfg, layers=layers)
        p["norm2"] = norm()
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, layers=layers)
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
                 cache=None, write_pools: bool = True):
    """One block of ``kind``.  Returns (x, new_cache)."""
    if kind in ("dense", "attn_local"):
        h, new_cache = attention_apply(
            p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
            positions=positions, cache=cache,
            window=cfg.local_window if kind == "attn_local" else 0,
            write_pools=write_pools,
        )
        x = x + h
        h = swiglu_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg.policy)
        return x + h, new_cache
    if kind == "ssm":
        h, new_state = ssm_lib.mamba2_apply(
            p["ssm"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, state=cache)
        return x + h, new_state
    if kind == "rec":
        h, new_state = griffin_lib.rglru_block_apply(
            p["rec"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, state=cache)
        x = x + h
        h = swiglu_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg.policy)
        return x + h, new_state
    raise ValueError(kind)


def _layer_kinds(cfg: ArchConfig) -> list[str]:
    if cfg.family == "dense":
        return ["dense"] * cfg.n_layers
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
    """cfg-driven functional model (dense, ssm and hybrid families)."""

    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet (ROADMAP "
                f"Queue A item 11b, 'Remaining model families'); ported: "
                f"{PORTED_FAMILIES}")
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

    def _stack(self, params: Params, x, *, caches=None, positions=None, write_pools=True):
        """Python loop over the layers in the reference's order (for the
        hybrid: every supergroup's pattern, then the remainder).  Returns
        (x, new_caches)."""
        new_caches = (None if caches is None
                      else {key: list(nodes) for key, nodes in caches.items()})
        for ly in self.layers:
            tree = params[ly.top][ly.key]
            p = tree if ly.index is None else layer_params(tree, ly.index)
            x, nc = _block_apply(
                p, x, self.cfg, ly.kind, positions=positions,
                cache=None if caches is None else caches[ly.cache_key][ly.node],
                write_pools=write_pools)
            if caches is not None:
                new_caches[ly.cache_key][ly.node] = nc
        return x, new_caches

    # -- full-sequence forward ------------------------------------------------

    @torch.no_grad()
    def apply(self, params: Params, batch: dict[str, Tensor]) -> tuple[Tensor, Tensor]:
        """Returns (logits, aux_loss); aux is 0 for the ported families."""
        tokens = batch["tokens"].to(self.device)
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._stack(params, x, positions=positions)
        return self._logits(params, x), torch.zeros((), device=x.device)

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
            if kind in ("dense", "attn_local"):
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
                    write_pools: bool = True) -> tuple[Tensor, DecodeState]:
        """tokens: (B, S_step) — one (or a few) new token(s) per sequence.
        The new state is returned.  A dense ``state`` is not modified; the
        pools of a paged state (``PagedKVCache`` nodes, shared by every row)
        receive the new K/V in place, unless ``write_pools=False``."""
        tokens = tokens.to(self.device)
        x = self._embed(params, tokens)
        # per-slot layout: position (B,) -> positions (B, S); shared: (S,)
        pos0 = state.position
        positions = (pos0[:, None] if pos0.dim() else pos0) + torch.arange(
            x.shape[1], device=x.device)
        x, nc = self._stack(params, x, caches=state.caches, positions=positions,
                            write_pools=write_pools)
        logits = self._logits(params, x)
        new_state = DecodeState(
            caches=nc,
            position=(state.position + tokens.shape[1]).to(torch.int32),
            enc_out=state.enc_out,
        )
        return logits, new_state


def build_model(cfg: ArchConfig, device=None) -> LanguageModel:
    """``device=None`` means the GPU and raises when there is none."""
    return LanguageModel(cfg, device=device)
