"""kimi-k2-1t-a32b [moe] — 384 experts top-8 + 1 shared, trillion-param MoE
[arXiv:2501.kimi2; unverified, paper-table].  d_ff is per-expert width."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    moe_experts=384,
    moe_top_k=8,
    moe_shared_experts=1,
    moe_first_dense=1,
    fsdp=True,
)
