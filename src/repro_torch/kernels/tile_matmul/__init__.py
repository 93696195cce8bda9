from repro_torch.kernels.tile_matmul.ops import (  # noqa: F401
    tile_grid,
    tile_matmul,
    tile_matmul_auto,
    tile_matmul_mode,
    tile_matmul_plain,
    tile_matmul_runtime,
)
