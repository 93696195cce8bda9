from repro_torch.kernels.limb_matmul.ops import (  # noqa: F401
    limb_matmul,
    limb_matmul_dd,
    limb_matmul_dd_plain,
    limb_matmul_plain,
)
