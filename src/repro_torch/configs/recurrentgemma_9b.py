"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, pattern
(rec, rec, attn) 1:2  [arXiv:2402.19427; unverified].  MQA kv=1; local
window 2048."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    hybrid_pattern=("rec", "rec", "attn_local"),
    local_window=2048,
    fsdp=True,
)
