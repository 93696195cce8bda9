"""The benchmark's weights: made on the device from the run's seed, in the
type they are served in (float32), one ``torch.randn`` per stacked leaf.

The tree has the layout the port's ``LanguageModel`` reads (layers stacked
on a leading axis under ``params["layers"]["seg0_<kind>"]``, weights
``(d_in, d_out)``), so the same tensors are handed to the program and to
the plain reference.  Norm scales are drawn too (the served norm is
``x * rsqrt(mean(x^2) + eps) * (1 + scale)``), so a reference that drops a
scale reads differently.
"""
from __future__ import annotations

import torch

from reference.model import Sizes


def make(sz: Sizes, seed: int, device) -> dict:
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
