from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention,
    decode_attention_plain,
)
