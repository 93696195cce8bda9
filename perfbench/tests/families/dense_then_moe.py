"""A family brought as new files only, for the tests: ``first_k_dense_replace``
leading dense layers (``seg0_dense``), then MoE layers whose routed experts
are joined by ``n_shared_experts`` shared ones (``seg1_moe``), as the port
computes them under ``moe_first_dense`` and ``moe_shared_experts``.  It is
built from the ``gqa`` family's parts, which it imports and does not edit."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from reference import gqa


@dataclasses.dataclass(frozen=True)
class Sizes(gqa.Sizes):
    first_dense: int = 1
    shared: int = 1


def sizes(cfg: dict) -> Sizes:
    return Sizes(**dataclasses.asdict(gqa.sizes(cfg)), first_dense=cfg["first_k_dense_replace"],
                 shared=cfg["n_shared_experts"])


def weights(sz: Sizes, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, e, hd = sz.d_model, sz.d_ff, sz.experts, sz.head_dim

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std

    def dense(n, a, b):
        return {"w": randn(n, a, b, std=(2.0 / (a + b)) ** 0.5)}

    def swiglu(n, width):
        return {"gate": dense(n, d, width), "up": dense(n, d, width), "down": dense(n, width, d)}

    def block(n):
        return {"norm1": randn(n, d, std=0.1),
                "attn": {"wq": dense(n, d, sz.n_heads * hd),
                         "wk": dense(n, d, sz.n_kv_heads * hd),
                         "wv": dense(n, d, sz.n_kv_heads * hd),
                         "wo": dense(n, sz.n_heads * hd, d)},
                "norm2": randn(n, d, std=0.1)}

    first, rest = sz.first_dense, sz.n_layers - sz.first_dense
    std = (2.0 / (d + f)) ** 0.5
    moe = {"router": {"w": randn(rest, d, e, std=0.02)}, "gate": randn(rest, e, d, f, std=std),
           "up": randn(rest, e, d, f, std=std), "down": randn(rest, e, f, d, std=std),
           "shared": swiglu(rest, f * sz.shared)}
    return {
        "embed": {"w": randn(sz.vocab, d, std=0.02)},
        "final_norm": randn(d, std=0.1),
        "layers": {"seg0_dense": block(first) | {"mlp": swiglu(first, f)},
                   "seg1_moe": block(rest) | {"moe": moe}},
        "unembed": {"w": randn(d, sz.vocab, std=0.02)},
    }


class Replay(gqa.Replay):
    """The ``gqa`` reference over both segments; a MoE layer adds its shared
    experts' SwiGLU, in float32, to the routed sum (rounded to bf16)."""

    def _mlp(self, p: dict, h: torch.Tensor, group: int) -> torch.Tensor:
        out = super()._mlp(p, h, group)
        if "moe" in p:
            s = p["moe"]["shared"]
            out = out + (F.silu(h @ s["gate"]["w"]) * (h @ s["up"]["w"])) @ s["down"]["w"]
        return out


def coupled_rows(sz: Sizes) -> bool:
    return True


def kernel_sites(sz: Sizes) -> list[tuple[int, list[tuple[int, int]]]]:
    d, hd = sz.d_model, sz.head_dim
    attn = [(d, sz.n_heads * hd), (d, sz.n_kv_heads * hd), (d, sz.n_kv_heads * hd),
            (sz.n_heads * hd, d)]

    def swiglu(width):
        return [(d, width), (d, width), (width, d)]

    return [(sz.first_dense, attn + swiglu(sz.d_ff)),
            (sz.n_layers - sz.first_dense, attn + swiglu(sz.d_ff * sz.shared))]


def active_params_per_token(sz: Sizes) -> int:
    d, hd, f = sz.d_model, sz.head_dim, sz.d_ff
    attn = d * (sz.n_heads + 2 * sz.n_kv_heads) * hd + sz.n_heads * hd * d
    moe = d * sz.experts + sz.top_k * 3 * d * f + 3 * d * f * sz.shared
    return (sz.first_dense * (attn + 3 * d * f) + (sz.n_layers - sz.first_dense) * (attn + moe)
            + d * sz.vocab)


attention_flops = gqa.attention_flops
