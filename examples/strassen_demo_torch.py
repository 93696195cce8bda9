"""The paper's own configuration (section 3) on the PyTorch/CUDA port: a 4x4
matrix multiplier built from 2x2-PE Strassen recursion with the
run-time-reconfigurable multiplier inside.

    PYTHONPATH=src python examples/strassen_demo_torch.py                # the GPU
    PYTHONPATH=src python examples/strassen_demo_torch.py --device cpu

The port's counterpart of ``examples/strassen_demo.py`` on the same operands
(numpy seed 0).  Without ``--device`` it runs on the GPU and raises when
there is none.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import paper_4x4
from repro_torch.core import Mode, mp_matmul
from repro_torch.core.strassen import leaf_products, strassen_matmul
from repro_torch.device import resolve_device

LADDER = (Mode.M8, Mode.M16, Mode.M24)


def operands() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    a = rng.standard_normal((paper_4x4.MATRIX_SIZE,) * 2).astype(np.float32)
    b = rng.standard_normal((paper_4x4.MATRIX_SIZE,) * 2).astype(np.float32)
    return a, b


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    a_np, b_np = operands()
    a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
    exact = a_np.astype(np.float64) @ b_np.astype(np.float64)

    size, pe, depth = paper_4x4.MATRIX_SIZE, paper_4x4.PE_SIZE, paper_4x4.STRASSEN_DEPTH
    print(f"paper config: {size}x{size} matrix, {pe}x{pe} PEs, Strassen depth {depth}")
    print(f"leaf products: {leaf_products(depth)} (classical would use 8)")

    errs, outputs, calls = {}, {}, {}
    for mode in LADDER:
        leaves = []

        def leaf(x, y, m=mode, leaves=leaves):
            leaves.append(tuple(x.shape))
            return mp_matmul(x, y, m, device=dev)

        out = strassen_matmul(a, b, depth=depth, leaf_fn=leaf, align=2)
        outputs[mode.name] = out.cpu().numpy()
        calls[mode.name] = len(leaves)
        errs[mode.name] = float(np.abs(outputs[mode.name].astype(np.float64) - exact).max())
        print(f"  PE mode {mode.name}: max abs err = {errs[mode.name]:.2e}")

    # the parallel-PE claim (section 3): the 7 sub-products are independent;
    # eager PyTorch launches them one after another on the current stream
    stream = "one CUDA stream" if dev.type == "cuda" else "the CPU"
    print(f"All 7 PE products are independent block products; eager PyTorch launches "
          f"them one after another on {stream} (no concurrency is claimed: none was measured)")
    return {"device": str(dev), "matrix_size": size, "pe_size": pe, "depth": depth,
            "leaf_products": leaf_products(depth), "leaf_calls": calls,
            "max_abs_err": errs, "outputs": outputs}


if __name__ == "__main__":
    main()
