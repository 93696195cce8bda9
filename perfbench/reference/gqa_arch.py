"""The port's ``ArchConfig`` for a configuration of the ``gqa`` family
(``gqa.py`` beside this file): a dense model, or a MoE one where the
configuration counts experts.  Kept apart from the reference so that the
reference imports nothing of the program."""
from __future__ import annotations


def arch(cfg: dict, sz, policy):
    """``sz``: ``gqa.sizes(cfg)``; ``policy``: the precision policy to
    serve at."""
    from repro_torch.models.config import ArchConfig

    srv = cfg["serving"]
    return ArchConfig(
        name=cfg["name"], family="moe" if sz.moe else "dense", n_layers=sz.n_layers,
        d_model=sz.d_model, n_heads=sz.n_heads, n_kv_heads=sz.n_kv_heads, d_ff=sz.d_ff,
        vocab=sz.vocab, head_dim=sz.head_dim, rope_theta=sz.rope_theta, norm_eps=sz.norm_eps,
        moe_experts=sz.experts, moe_top_k=sz.top_k, moe_capacity_factor=sz.capacity_factor,
        moe_group_size=sz.group_size, attn_chunk=srv.get("attn_chunk", 1024),
        param_dtype=srv["param_dtype"], kv_cache_dtype=srv["kv_cache_dtype"], policy=policy)
