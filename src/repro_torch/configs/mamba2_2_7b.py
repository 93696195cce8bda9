"""mamba2-2.7b [ssm] — SSD (state-space duality)  [arXiv:2405.21060; unverified].
Attention-free: n_heads refers to SSD heads (d_inner / ssm_head_dim)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)
