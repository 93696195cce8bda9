#!/usr/bin/env python3
"""dist_ranks_check.py — run the port's multi-rank CPU checks without JAX.

Run from the root of a checkout on any machine with PyTorch (no GPU, no
JAX needed):

    python3 tools/dist_ranks_check.py [--out build/dist_ranks.jsonl]

It makes the inputs of the rank programs in ``tests/torch_dist_ranks.py``
with numpy and the port alone (qwen1.5-0.5b's, Phi-3.5-MoE's and Kimi-K2's
smoke parameters from the port's ``init(0)``, a reference-format checkpoint
written by the port's manager), runs each scenario as four gloo ranks on the CPU, and prints one
JSON line per rank: its exit code, its record as far as it got (the
replica hashes left out) and, when it failed, the end of its output.  The
tests hold the records against the reference's results; this script shows
which scenarios run at all under the PyTorch installed where it runs.
Exits non-zero when a rank failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager, _flatten  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

WORLD = 4
SCENARIOS = ("step_2x2", "pod", "shardwise", "moe")
#: the ``moe`` scenario's archs, by the key of their inputs
MOE_ARCHS = {"phi": "phi3.5-moe-42b-a6.6b", "kimi": "kimi-k2-1t-a32b"}
#: the pipeline's stages, microbatches, rows and width (as the tests')
S, M, B, D = 4, 6, 2, 16


def make_inputs() -> dict:
    cfg = get_smoke_config("qwen1.5-0.5b")
    params = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (8, 33)).astype(np.int32)
    inputs = {
        "tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
        "g_rep": rng.standard_normal(1024).astype(np.float32),
        "g_pod0": rng.standard_normal(1000).astype(np.float32),
        "g_pod1": (rng.standard_normal(1000) * 3).astype(np.float32),
        "r_pod0": (rng.standard_normal(1000) * 0.01).astype(np.float32),
        "r_pod1": (rng.standard_normal(1000) * 0.01).astype(np.float32),
        "g2_pod0": rng.standard_normal((24, 40)).astype(np.float32),
        "g2_pod1": (rng.standard_normal((24, 40)) * 2).astype(np.float32),
        "r2_pod0": (rng.standard_normal((24, 40)) * 0.01).astype(np.float32),
        "r2_pod1": (rng.standard_normal((24, 40)) * 0.01).astype(np.float32),
        "pipe_w": (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
        "pipe_x": rng.standard_normal((M, B, D)).astype(np.float32),
        "split_x": rng.standard_normal((6, 64)).astype(np.float32),
    }
    inputs.update({f"params/{k}": v.numpy() for k, v in _flatten(params).items()})
    inputs["moe_x"] = rng.standard_normal((4, 64, 128)).astype(np.float32)
    inputs["moe_probe"] = rng.standard_normal(128).astype(np.float32)
    for tag, arch in MOE_ARCHS.items():
        moe_params = build_model(get_smoke_config(arch), device="cpu").init(0)
        inputs.update({f"params_{tag}/{k}": v.numpy()
                       for k, v in _flatten(moe_params).items()})
    return inputs


def run(scenario: str, inputs: dict, timeout: float) -> list[dict]:
    d = tempfile.mkdtemp(prefix=f"dist_ranks_{scenario}_")
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    CheckpointManager(os.path.join(d, "ref_ckpt"), async_save=False).save(
        3, {"x": torch.arange(64.0) * 2, "opt": {"step": torch.tensor(3, dtype=torch.int32)}})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_ranks.py"), scenario,
         str(r), str(WORLD), d], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    out = []
    try:
        for r, p in enumerate(procs):
            log = p.communicate(timeout=timeout)[0]
            rec = {"scenario": scenario, "rank": r, "exit": p.returncode}
            path = os.path.join(d, f"rank{r}.json")
            if os.path.exists(path):  # written as far as the rank got
                with open(path) as fh:
                    record = json.load(fh)
                rec.update({k: v for k, v in record.items() if not k.endswith("replicas")})
            if p.returncode:
                rec["log_tail"] = log[-3000:]
            out.append(rec)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    ap.add_argument("--timeout", type=float, default=400.0, help="seconds per scenario")
    args = ap.parse_args()
    inputs = make_inputs()
    lines = [json.dumps({"torch": torch.__version__})]
    print(lines[0], flush=True)
    failed = False
    for scenario in SCENARIOS:
        for rec in run(scenario, inputs, args.timeout):
            failed |= rec["exit"] != 0
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
