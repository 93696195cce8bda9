"""qwen1.5-4b [dense] — QKV bias  [hf:Qwen/Qwen1.5-0.5B family; hf].

20 heads do not divide the 16-way model axis -> sequence-parallel attention.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    attn_shard="sequence",
    fsdp=True,
)
