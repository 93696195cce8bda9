"""whisper-medium [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].  input_specs provides precomputed frame
embeddings (B, S_frames, d_model); RoPE replaces sinusoidal/learned positions
(documented modernization, DESIGN.md)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
)
