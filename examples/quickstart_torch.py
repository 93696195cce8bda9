"""Quickstart on the PyTorch/CUDA port: the run-time-reconfigurable
multi-precision matmul engine on an NVIDIA GPU.

    PYTHONPATH=src python examples/quickstart_torch.py                # the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain versions

The port's counterpart of ``examples/quickstart.py``, section for section,
on the same operands (numpy seed 0):
  * the precision ladder through the plain limb algebra (``impl='xla'``) and
    the hand-written limb kernel (``impl='pallas'``)
  * run-time reconfiguration: ONE captured CUDA graph of
    ``mp_matmul_runtime(..., impl='tile')`` replayed at every mode, the mode
    a device int32 scalar the mode-map kernel reads as data — nothing is
    captured or built again when it changes
  * auto-mode (paper mode 1): the operand probe picks the cheapest precision
  * Strassen block matmul with 7 leaf products (paper section 3.1)
  * the planner on the H100 cost model: shape + accuracy -> (mode, depth, impl)

Without ``--device`` it runs on the GPU and raises when there is none.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    MODE_PASSES,
    Mode,
    auto_mode,
    mp_matmul,
    mp_matmul_runtime,
    strassen_matmul,
)
from repro_torch.device import backend_of, resolve_device
from repro_torch.kernels import build
from repro_torch.plan import matmul as planned_matmul
from repro_torch.plan import plan_matmul
from repro_torch.serve.graphs import CompiledStep

N = 256
LADDER = (Mode.M8, Mode.M16, Mode.M24)
#: (n, accuracy) of the three printed plans (the reference's)
PLANS = ((256, 2**-4), (4096, 2**-12), (16384, 2**-20))


def operands(n: int = N) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's draws in its order: a, b ~ N(0, 1), then integer
    operands in [0, 100)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    ai = rng.integers(0, 100, (n, n)).astype(np.float32)
    return a, b, ai


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    a_np, b_np, ai_np = operands()
    a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
    ai = torch.from_numpy(ai_np).to(dev)
    exact = a_np.astype(np.float64) @ b_np.astype(np.float64)

    def rel_err(out) -> float:
        got = out.detach().cpu().numpy().astype(np.float64)
        return float(np.abs(got - exact).max() / np.abs(exact).max())

    result: dict = {"device": str(dev), "outputs": {}}
    launches0 = build.launch_counts()

    print("=== precision ladder (static modes) ===")
    ladder, pallas = {}, {}
    for mode in LADDER:
        xla = mp_matmul(a, b, mode, impl="xla", device=dev)
        pallas[mode] = mp_matmul(a, b, mode, impl="pallas", device=dev)
        ladder[mode.name] = {"passes": MODE_PASSES[mode], "xla": rel_err(xla),
                             "pallas": rel_err(pallas[mode])}
        result["outputs"][mode.name] = {"xla": xla.cpu().numpy(),
                                        "pallas": pallas[mode].cpu().numpy()}
        print(f"  {mode.name}: {MODE_PASSES[mode]} tensor-core pass(es), "
              f"rel_err={ladder[mode.name]['xla']:.2e} (limb algebra), "
              f"{ladder[mode.name]['pallas']:.2e} (limb kernel)")
    result["ladder"] = ladder

    print("=== run-time reconfiguration: ONE captured graph ===")
    # the graph reads its operands and its mode from these buffers; the mode
    # is written, never passed, so every replay is the same captured work
    a_s, b_s = a.clone(), b.clone()
    mode_s = torch.ones((), dtype=torch.int32, device=dev)
    step = CompiledStep(
        lambda: mp_matmul_runtime(a_s, b_s, mode_s, impl="tile", allow_auto=False,
                                  device=dev),
        dev, name="quickstart_runtime")
    tile0 = build.launch_counts()["tile_matmul"]
    replays, equal = {}, {}
    for mode_bits in (1, 2, 3):
        mode_s.fill_(mode_bits)
        out = step().clone()  # the next replay overwrites the graph's output
        replays[mode_bits] = rel_err(out)
        equal[mode_bits] = bool(torch.equal(out, pallas[Mode(mode_bits)]))
        print(f"  mode bits={mode_bits:03b}: rel_err={replays[mode_bits]:.2e}, "
              f"bit-equal to the limb kernel: {equal[mode_bits]}")
    runtime = {"rel_err": replays, "bit_equal": equal, "graphs": step.captures,
               "replays": step.replays, "builds": build.BUILD_COUNT,
               "tile_launches": build.launch_counts()["tile_matmul"] - tile0}
    result["runtime"] = runtime
    step.close()
    if dev.type == "cuda":
        print(f"  graphs captured: {runtime['graphs']} "
              f"(the paper's 'no re-synthesis'), replays: {runtime['replays']}")
        print(f"  kernel builds: {runtime['builds']}, mode-map kernel launches: "
              f"{runtime['tile_launches']} (one warm-up before the capture, one a replay)")
    else:
        print(f"  graphs captured: {runtime['graphs']}, kernel builds: {runtime['builds']} "
              "(on the CPU the step runs eagerly through the plain versions)")

    print("=== auto-mode (paper mode 1 / Fig 7) ===")
    auto = {"float": Mode(int(auto_mode(a, b))).name, "int": Mode(int(auto_mode(ai, ai))).name}
    print(f"  float operands  -> mode {auto['float']}")
    print(f"  integer operands-> mode {auto['int']}")
    out = mp_matmul_runtime(ai, ai, torch.zeros((), dtype=torch.int32, device=dev),
                            impl="tile", device=dev)  # AUTO, read on the device
    exact_int = ai_np.astype(np.float64) @ ai_np.astype(np.float64)
    auto["int_exact"] = bool(np.array_equal(out.cpu().numpy().astype(np.float64), exact_int))
    print(f"  integer product exact: {auto['int_exact']}")
    result["auto"] = auto

    print("=== Strassen (7 multiplications per 2x2 level) ===")
    leaves = []

    def leaf(x, y):
        leaves.append(tuple(x.shape))
        return x @ y

    out = strassen_matmul(a, b, depth=1, leaf_fn=leaf, align=64)
    strassen = {"rel_err": rel_err(out), "leaf_products": len(leaves)}
    print(f"  depth=1: rel_err={strassen['rel_err']:.2e}, "
          f"leaf matmuls={strassen['leaf_products']} (classical: 8)")
    out = mp_matmul(a, b, Mode.M16, strassen_depth=1, device=dev)
    strassen["m16_rel_err"] = rel_err(out)
    print("  Strassen OUTSIDE x RMPM M16 INSIDE (the paper's full stack): "
          f"rel_err={strassen['m16_rel_err']:.2e}")
    result["strassen"] = strassen

    print("=== the planner: shape + accuracy -> (mode, depth, impl) ===")
    plans = []
    for n, acc in PLANS:
        p = plan_matmul((n, n), (n, n), accuracy=acc, backend="gpu")
        plans.append({"n": n, "accuracy": acc, "mode": p.mode.name, "impl": p.impl,
                      "depth": p.strassen_depth, "dominant": p.cost.dominant})
        print(f"  ({n}x{n}) @ acc 2^{int(np.log2(acc))}: {p.mode.name}/"
              f"{p.impl}/depth={p.strassen_depth} ({p.cost.dominant}-bound, H100 model)")
    result["plans"] = plans
    out = planned_matmul(a, b, accuracy=2**-12, device=dev)  # plans for THIS device
    result["planned_rel_err"] = rel_err(out)
    print(f"  planned execution on {dev} ({backend_of(dev)} cost model): "
          f"rel_err={result['planned_rel_err']:.2e}")

    after = build.launch_counts()
    result["launches"] = {k: after[k] - launches0[k] for k in after}
    return result


if __name__ == "__main__":
    main()
