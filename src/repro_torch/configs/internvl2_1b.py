"""internvl2-1b [vlm] — InternViT frontend (stub) + InternLM2 backbone
[arXiv:2404.16821; hf].  14 heads do not divide the model axis -> SP attention.
The modality frontend is a STUB per the assignment: input_specs provides
precomputed patch embeddings (B, n_vision_tokens, d_model)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    n_vision_tokens=256,
    attn_shard="sequence",
)
