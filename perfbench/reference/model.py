"""Plain PyTorch reference of the served models: Phi-3 dense and Phi-3.5-MoE.

Float32 throughout, with TF32 off, and no kernel, no limb split, no CUDA
graph.  It imports nothing of the program: where the judged output depends
on a choice the serving system makes (its rounding points, its routing
groups), that choice is written out again here as a frozen copy of the
semantics, named where it is used:

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
program served.  It returns, for each served token, the gap by which the
reference's logit of that token lies below the reference's best.
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

    ``params`` is the benchmark's tree (``harness.weights``).  Each request
    gets a row of the reference's own bf16 cache when its prefill is
    replayed and gives it back when ``release`` is called.
    """

    def __init__(self, sz: Sizes, params: dict, rows: int, max_len: int, device):
        self.sz, self.params, self.device = sz, params, device
        kind = "seg0_moe" if sz.moe else "seg0_dense"
        self.layers = [layer_params(params["layers"][kind], i) for i in range(sz.n_layers)]
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
        if self.sz.moe:
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


def gap(logits: Tensor, token: Tensor) -> Tensor:
    """By how much the served ``token``'s logit lies below the best:
    logits (..., V), token (...,) -> (...,) >= 0."""
    return logits.max(dim=-1).values - logits.gather(-1, token[..., None])[..., 0]
