"""Architecture configuration shared by every assigned model family."""
from __future__ import annotations

import dataclasses

from repro_torch.core.policy import NATIVE_F32, PAPER_BASELINE, PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_first_dense: int = 0  # leading dense layers before MoE stack
    moe_group_size: int = 512  # dispatch group (tokens) for capacity routing

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (RG-LRU + local attention, Griffin pattern rec,rec,attn)
    hybrid_pattern: tuple[str, ...] = ()
    local_window: int = 0  # sliding-window size for local attention (0 = full)

    # enc-dec
    n_encoder_layers: int = 0

    # vlm
    n_vision_tokens: int = 0

    # execution
    attn_shard: str = "heads"  # 'heads' (TP) | 'sequence' (SP) — see sharding.py
    attn_chunk: int = 1024  # flash-attention KV chunk (memory-roofline lever)
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"  # 'bfloat16' | 'int8' (precision lever)
    remat: bool = True
    fsdp: bool = False  # additionally shard params over the data axis
    policy: PrecisionPolicy = PAPER_BASELINE

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with O(1)/O(window) state (long_500k gate)?"""
        return self.family in ("ssm", "hybrid")

    def with_policy(self, policy: PrecisionPolicy) -> "ArchConfig":
        return dataclasses.replace(self, policy=policy)

    def for_cpu_example(self) -> "ArchConfig":
        return dataclasses.replace(self, policy=NATIVE_F32, remat=False)


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Shrink any config to a CPU-runnable smoke size, same family/topology."""
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 4 if not cfg.hybrid_pattern else 6),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=256,
        vocab=512,
        head_dim=32,
        attn_chunk=64,
        remat=False,
        moe_group_size=64,
    )
    if cfg.moe_experts:
        changes.update(moe_experts=4, moe_top_k=min(cfg.moe_top_k, 2), moe_first_dense=min(cfg.moe_first_dense, 1))
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.local_window:
        changes.update(local_window=32)
    if cfg.n_encoder_layers:
        changes.update(n_encoder_layers=2)
    if cfg.n_vision_tokens:
        changes.update(n_vision_tokens=16)
    if cfg.hybrid_pattern:
        changes.update(n_layers=6)  # two (rec, rec, attn) groups + remainder 0
    return dataclasses.replace(cfg, **changes)
