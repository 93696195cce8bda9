"""The ``gqa`` family: grouped-query attention with RoPE over a bf16 KV
cache, then a SwiGLU MLP (Phi-3 dense) or a softmax top-k MoE with capacity
routing (Phi-3.5-MoE), one stacked segment of layers.

A configuration file names its family (``"reference": "gqa"``) and the
harness finds everything that depends on the architecture here: ``sizes``
(the configuration's keys the rest reads; ``vocab`` is what the traffic
draws from), ``weights`` (the tree in the port's layout, handed to the
program and to the reference alike), :class:`Replay` (the plain reference),
``coupled_rows`` (the check's row policy) and the work counts
``kernel_sites``, ``active_params_per_token`` and ``attention_flops``.  The
port's ``ArchConfig`` comes from ``gqa_arch.py`` beside this file, so this
one imports nothing of the program.

The reference is plain PyTorch: float32 throughout, with TF32 off, and no
kernel, no limb split, no CUDA graph.  Where the judged output depends on a
choice the serving system makes (its rounding points, its routing groups),
that choice is written out again here as a frozen copy of the semantics,
named where it is used:

* the KV cache holds keys and values in bfloat16: a prefill attends over
  its own fresh float32 keys and values, a decode step over the cached,
  rounded ones (its own included);
* RoPE rotates the two halves of each head (theta ** (-i / half));
* a MoE layer routes GShard-style with capacity: softmax router, top-k by a
  stable descending sort, weights renormalised, positions counted k-major
  over the routing group, assignments past ``capacity`` dropped.  A prefill
  routes in groups of ``min(group_size, S)`` tokens of its own prompt; a
  decode step routes the whole batch of rows as one group, so the rows of
  one step compete for expert slots in row order.  Tokens enter the
  experts rounded to bf16; each expert output and combine weight is rounded
  to bf16, the kept products summed in float32 in ascending expert order
  and the sum rounded to bf16.

:class:`Replay` follows a served run: the same prefills, and the same
decode steps with the same rows in the same order, fed the tokens the
program served, and returns the logits of each.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What the reference needs of a configuration."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    group_size: int = 512

    @property
    def moe(self) -> bool:
        return self.experts > 0


def sizes(cfg: dict) -> Sizes:
    """The reference's sizes from a configuration file's published keys."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    srv = cfg["serving"]
    return Sizes(
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], head_dim=cfg.get("head_dim") or d // h,
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        experts=cfg.get("num_local_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
        capacity_factor=srv.get("moe_capacity_factor", 1.25),
        group_size=srv.get("moe_group_size", 512))


def weights(sz: Sizes, seed: int, device) -> dict:
    """The benchmark's weights: made on the device from the run's seed, in
    the type they are served in (float32), one ``torch.randn`` per stacked
    leaf.

    The tree has the layout the port's ``LanguageModel`` reads (layers
    stacked on a leading axis under ``params["layers"]["seg0_<kind>"]``,
    weights ``(d_in, d_out)``), so the same tensors are handed to the
    program and to the reference.  Norm scales are drawn too (the served
    norm is ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``), so a reference
    that drops a scale reads differently."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, d, f = sz.n_layers, sz.d_model, sz.d_ff
    hq, hkv, hd = sz.n_heads, sz.n_kv_heads, sz.head_dim

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std

    def dense(*shape):
        return {"w": randn(L, *shape, std=(2.0 / (shape[0] + shape[1])) ** 0.5)}

    block = {
        "norm1": randn(L, d, std=0.1),
        "attn": {"wq": dense(d, hq * hd), "wk": dense(d, hkv * hd),
                 "wv": dense(d, hkv * hd), "wo": dense(hq * hd, d)},
        "norm2": randn(L, d, std=0.1),
    }
    if sz.moe:
        e, std = sz.experts, (2.0 / (d + f)) ** 0.5
        block["moe"] = {"router": {"w": randn(L, d, e, std=0.02)},
                        "gate": randn(L, e, d, f, std=std), "up": randn(L, e, d, f, std=std),
                        "down": randn(L, e, f, d, std=std)}
    else:
        block["mlp"] = {"gate": dense(d, f), "up": dense(d, f), "down": dense(f, d)}
    return {
        "embed": {"w": randn(sz.vocab, d, std=0.02)},
        "final_norm": randn(d, std=0.1),
        "layers": {"seg0_moe" if sz.moe else "seg0_dense": block},
        "unembed": {"w": randn(d, sz.vocab, std=0.02)},
    }


def coupled_rows(sz: Sizes) -> bool:
    """Whether the rows of one decode step share state: a MoE model's rows
    compete for expert capacity, so the check judges every request and
    every step must hold every slot; a dense model's rows are independent."""
    return sz.moe


def kernel_sites(sz: Sizes) -> list[tuple[int, list[tuple[int, int]]]]:
    """(layers, (K, N) of each site of one such layer) of every run of
    like layers: the two-operand ``mk,kn->mn`` sites the port sends to the
    limb kernel under an ``impl='pallas'`` policy, the attention
    projections and a dense layer's SwiGLU.  (The router, the experts,
    attention's products and the logits are general einsums, outside the
    kernel.)"""
    d, hd = sz.d_model, sz.head_dim
    sites = [(d, sz.n_heads * hd), (d, sz.n_kv_heads * hd), (d, sz.n_kv_heads * hd),
             (sz.n_heads * hd, d)]
    if not sz.moe:
        sites += [(d, sz.d_ff), (d, sz.d_ff), (sz.d_ff, d)]
    return [(sz.n_layers, sites)]


def active_params_per_token(sz: Sizes) -> int:
    """Weights one token multiplies by: every layer's attention projections
    and its MLP (a MoE layer: its router and ``top_k`` experts), and the
    output head.  The embedding is a lookup."""
    d, hd = sz.d_model, sz.head_dim
    attn = d * (sz.n_heads + 2 * sz.n_kv_heads) * hd + sz.n_heads * hd * d
    mlp = (d * sz.experts + sz.top_k * 3 * d * sz.d_ff) if sz.moe else 3 * d * sz.d_ff
    return sz.n_layers * (attn + mlp) + d * sz.vocab


def attention_flops(sz: Sizes, keys: int) -> float:
    """Scores and weighted values of one query over ``keys`` keys, every
    layer."""
    return sz.n_layers * 4.0 * sz.n_heads * sz.head_dim * keys


def bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = (positions.to(torch.float32)[..., None] * freqs)[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def capacity(tokens: int, sz: Sizes) -> int:
    return max(1, int(-(-tokens * sz.top_k // sz.experts) * sz.capacity_factor))


def moe(p: dict, x: Tensor, sz: Sizes, group: int) -> Tensor:
    """x: (T, D) tokens, routed in consecutive groups of ``group`` tokens."""
    t, d = x.shape
    e, k = sz.experts, sz.top_k
    out = torch.empty_like(x)
    for g0 in range(0, t, group):
        xg = x[g0:g0 + group]
        n = xg.shape[0]
        cap = capacity(n, sz)
        probs = torch.softmax(xg @ p["router"]["w"], dim=-1)
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, ids = vals[:, :k], ids[:, :k]
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
        # k-major running count per expert: every first choice before any second
        onehot = (ids.T.reshape(-1)[:, None] == torch.arange(e, device=x.device)).to(torch.int64)
        pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, ids.T.reshape(-1, 1))[:, 0]
        pos = pos.reshape(k, n).T
        keep = pos < cap
        xin = bf16(xg)
        acc = torch.zeros_like(xg)
        order = torch.argsort(torch.where(keep, ids, e), dim=-1, stable=True)
        ids_o, keep_o = ids.gather(1, order), keep.gather(1, order)
        w_o = torch.where(keep_o, bf16(w.gather(1, order)), torch.zeros_like(w))
        contrib = torch.zeros((n, k, d), dtype=torch.float32, device=x.device)
        for ex in torch.unique(ids_o[keep_o]).tolist():
            sel = (ids_o == ex) & keep_o
            rows, slot = sel.nonzero(as_tuple=True)
            h = F.silu(xin[rows] @ p["gate"][ex]) * (xin[rows] @ p["up"][ex])
            contrib[rows, slot] = bf16(h @ p["down"][ex])
        for j in range(k):
            acc = acc + contrib[:, j] * w_o[:, j:j + 1]
        out[g0:g0 + group] = bf16(acc)
    return out


def layer_params(tree: dict, i: int) -> dict:
    if isinstance(tree, dict):
        return {key: layer_params(v, i) for key, v in tree.items()}
    return tree[i]


class Replay:
    """The reference run over a served schedule.

    ``params`` is the tree ``weights`` made; its layers are taken segment
    by segment in the tree's order.  Each request gets a row of the
    reference's own bf16 cache when its prefill is replayed and gives it
    back when ``release`` is called.
    """

    def __init__(self, sz: Sizes, params: dict, rows: int, max_len: int, device):
        self.sz, self.params, self.device = sz, params, device
        self.layers = [layer_params(seg, i) for seg in params["layers"].values()
                       for i in range(seg["norm1"].shape[0])]
        shape = (sz.n_layers, rows, max_len, sz.n_kv_heads, sz.head_dim)
        self.k = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        self.v = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        self.free = list(range(rows))
        self.row: dict[int, int] = {}
        self.length: dict[int, int] = {}

    def release(self, rid: int) -> None:
        self.free.append(self.row.pop(rid))
        del self.length[rid]

    def _logits(self, x: Tensor) -> Tensor:
        x = rms_norm(x, self.params["final_norm"], self.sz.norm_eps)
        return x @ self.params["unembed"]["w"]

    def _mlp(self, p: dict, h: Tensor, group: int) -> Tensor:
        """h: (T, D)."""
        if "moe" in p:
            return moe(p["moe"], h, self.sz, group)
        m = p["mlp"]
        return (F.silu(h @ m["gate"]["w"]) * (h @ m["up"]["w"])) @ m["down"]["w"]

    def _qkv(self, p: dict, x: Tensor, positions: Tensor):
        sz = self.sz
        b, s, _ = x.shape
        h = rms_norm(x, p["norm1"], sz.norm_eps)
        a = p["attn"]
        q = (h @ a["wq"]["w"]).reshape(b, s, sz.n_heads, sz.head_dim)
        k = (h @ a["wk"]["w"]).reshape(b, s, sz.n_kv_heads, sz.head_dim)
        v = (h @ a["wv"]["w"]).reshape(b, s, sz.n_kv_heads, sz.head_dim)
        return rope(q, positions, sz.rope_theta), rope(k, positions, sz.rope_theta), v

    def _attend(self, q: Tensor, k: Tensor, v: Tensor, valid: Tensor) -> Tensor:
        """q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd) f32, valid: (B, Sq, Skv)."""
        sz = self.sz
        b, sq = q.shape[:2]
        g = sz.n_heads // sz.n_kv_heads
        qg = q.reshape(b, sq, sz.n_kv_heads, g, sz.head_dim) * sz.head_dim ** -0.5
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
        s = s.masked_fill(~valid[:, None, None], -math.inf)
        o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)
        return o.reshape(b, sq, sz.n_heads * sz.head_dim)

    def prefill(self, rid: int, prompt: Tensor) -> Tensor:
        """The prompt (S,) int64 through every layer; returns the last
        position's logits (V,) and keeps the rounded K/V as the cache."""
        sz = self.sz
        row = self.free.pop()
        self.row[rid] = row
        s = prompt.shape[0]
        self.length[rid] = s
        x = self.params["embed"]["w"][prompt][None]
        pos = torch.arange(s, device=self.device)[None]
        causal = torch.ones((s, s), dtype=torch.bool, device=self.device).tril()[None]
        group = min(sz.group_size, s)
        for li, p in enumerate(self.layers):
            q, k, v = self._qkv(p, x, pos)
            self.k[li, row, :s] = k[0].to(torch.bfloat16)
            self.v[li, row, :s] = v[0].to(torch.bfloat16)
            x = x + self._attend(q, k, v, causal) @ p["attn"]["wo"]["w"]
            x = x + self._mlp(p, rms_norm(x, p["norm2"], sz.norm_eps)[0], group)[None]
        return self._logits(x[0, -1])

    def decode(self, rids: list[int], tokens: Tensor) -> Tensor:
        """One decode step of the rows ``rids`` (in the program's row order)
        fed ``tokens`` (B,); returns their logits (B, V)."""
        sz = self.sz
        b = len(rids)
        rows = torch.tensor([self.row[r] for r in rids], device=self.device)
        lens = torch.tensor([self.length[r] for r in rids], device=self.device)
        ctx = int(lens.max()) + 1
        x = self.params["embed"]["w"][tokens][:, None]
        valid = (torch.arange(ctx, device=self.device)[None] <= lens[:, None])[:, None]
        for li, p in enumerate(self.layers):
            q, k, v = self._qkv(p, x, lens[:, None])
            self.k[li, rows, lens] = k[:, 0].to(torch.bfloat16)
            self.v[li, rows, lens] = v[:, 0].to(torch.bfloat16)
            kc = self.k[li, rows, :ctx].to(torch.float32)
            vc = self.v[li, rows, :ctx].to(torch.float32)
            x = x + (self._attend(q, kc, vc, valid) @ p["attn"]["wo"]["w"])
            x = x + self._mlp(p, rms_norm(x, p["norm2"], sz.norm_eps)[:, 0], b)[:, None]
        for r in rids:
            self.length[r] += 1
        return self._logits(x[:, 0])

