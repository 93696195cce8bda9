from repro_torch.kernels.quantize_mantissa.ops import (  # noqa: F401
    quantize_mantissa_op,
    quantize_mantissa_plain,
)
