"""Tests of the benchmark harness (not collected by the repository's own
``tests/`` run; run them with ``python -m pytest perfbench/tests``).

Tests marked ``chip`` need a CUDA device: they skip here and run on the
card with ``python -m pytest perfbench/tests -m chip``."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (runs on the card)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


TINY = {"reference": "gqa", "hidden_size": 64, "intermediate_size": 96,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
        "vocab_size": 4096,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "serving": {"mode": "M16", "impl": "pallas", "param_dtype": "float32",
                    "kv_cache_dtype": "bfloat16", "attn_chunk": 16, "moe_group_size": 32}}
TRAFFIC = {
    "closed_loop": {"kind": "closed_loop", "slots": 4, "max_len": 64, "clients": 4,
                    "prompt": {"median": 12, "sigma": 0.5, "min": 4, "max": 32},
                    "output": {"median": 10, "sigma": 0.5, "min": 4, "max": 20},
                    "pool": 64, "max_prefill": 32, "judge_requests": 3},
    "poisson": {"kind": "poisson", "slots": 3, "max_len": 64, "rate": 20.0, "schedule_seed": 0,
                "prompt": {"median": 16, "sigma": 0.5, "min": 4, "max": 32},
                "output": {"dist": "uniform", "min": 2, "max": 6},
                "warm_prompts": [32, 4], "warm_output": 2, "judge_requests": 5},
}


#: the tiny cells' limits: a dense model is held to its widest gap; a MoE
#: model's capacity routing flips an expert at near ties, so it is held to
#: the share of tokens off the reference's best, and its widest gap loosely
LIMITS = {False: {"widest_logit_gap": 1e-3},
          True: {"off_best_share": 0.05, "widest_logit_gap": 0.05}}


def tiny_root(root: Path, *, moe: bool, kind: str) -> Path:
    """A checkout holding the real benchmark plus one tiny cell
    (``tiny-cell``), added as new files and new entries only."""
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    cfg = dict(TINY, name="tiny")
    if moe:
        cfg.update(num_local_experts=4, num_experts_per_tok=2)
    (root / "perfbench/configs/tiny.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/tiny.json").write_text(json.dumps(TRAFFIC[kind]))
    (root / "perfbench/cells/tiny-cell.json").write_text(
        json.dumps({"limits": LIMITS[moe]}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test", "reduced": [], "why": "test",
                             "file": "perfbench/configs/tiny.json"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
