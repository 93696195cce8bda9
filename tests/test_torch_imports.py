"""The port stands alone: importing every ``repro_torch`` module leaves
neither ``jax`` nor the reference package ``repro`` in ``sys.modules``, builds
nothing and needs neither a GPU nor ``triton``; ``chip_smoke.py`` imports
neither package."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import repro_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, prefix="repro_torch."))

_PROBE = """
import importlib, json, sys
seen, report = set(), {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton', 'flax', 'optax'))
    report[name] = [m for m in bad if m not in seen]  # charged to the first importer
    seen.update(bad)
from repro_torch.kernels import build
report['BUILD_COUNT'] = build.BUILD_COUNT
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def import_report():
    """One fresh interpreter imports every module in turn and notes what each
    import newly dragged into ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE, *MODULES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _imported_roots(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_package_has_the_modules_of_the_slice():
    for want in ("core.rmpm", "core.strassen", "plan.planner", "plan.cost",
                 "kernels.build", "kernels.limb_matmul.ops", "kernels.tile_matmul.ops",
                 "kernels.tile_matmul.tile_policy", "kernels.quantize_mantissa.ops",
                 "models.layers", "models.lm", "adapt.controller", "adapt.pages", "adapt.probe",
                 "adapt.runtime_policy", "obs.tracer", "serve.engine", "serve.scheduler",
                 "serve.tenancy", "serve.metrics", "serve.config", "serve.paged",
                 "launch.serve", "convert", "configs.qwen1_5_0_5b",
                 "models.moe", "models.ssm", "models.griffin", "configs.qwen1_5_4b",
                 "configs.phi3_mini_3_8b", "configs.command_r_plus_104b",
                 "configs.phi3_5_moe_42b", "configs.kimi_k2_1t", "configs.whisper_medium",
                 "configs.internvl2_1b", "configs.mamba2_2_7b", "configs.recurrentgemma_9b",
                 "tune", "tune.table", "tune.runner", "tune.__main__",
                 "spec", "spec.config", "spec.rollout",
                 "tree", "optim.adamw", "train.step", "train.loop", "data.pipeline",
                 "checkpoint.manager", "distributed.sharding", "launch.train",
                 "distributed.compress", "distributed.pipeline", "launch.mesh",
                 "oprecord", "launch.op_cost", "launch.shapes", "launch.dryrun", "analysis",
                 "analysis.__main__", "analysis.report", "analysis.lint", "analysis.dispatch",
                 "analysis.flow", "analysis.hotpaths", "configs.paper_4x4"):
        assert f"repro_torch.{want}" in MODULES, want


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_without_jax_or_the_reference(import_report, name):
    assert import_report[name] == [], f"{name} pulled in: {import_report[name]}"


def test_importing_builds_nothing(import_report):
    assert import_report["BUILD_COUNT"] == 0


@pytest.mark.parametrize("rel", ["chip_smoke.py"] + sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(os.path.join(SRC, "repro_torch")) for f in files
    if f.endswith(".py")))
def test_source_names_neither_jax_nor_the_reference(rel):
    roots = _imported_roots(os.path.join(ROOT, rel))
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, (rel, roots)
    if rel != "chip_smoke.py":
        # triton, where it is used at all, is imported inside the launching function
        assert "triton" not in roots


def test_kernel_sources_keep_torch_headers_out():
    csrc = os.path.join(SRC, "repro_torch", "csrc")
    names = sorted(os.listdir(csrc))
    assert {"limb_matmul.cu", "tile_matmul.cu", "quantize_mantissa.cu",
            "limb_matmul_dd.cu"} <= set(names)
    for name in names:
        with open(os.path.join(csrc, name)) as fh:
            text = fh.read()
        assert "torch/" not in text and "ATen" not in text, name
        assert "cublas" not in text.lower() and "cutlass" not in text.lower(), name


def test_chip_smoke_refuses_to_run_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        return  # on a GPU the script runs its phases; the CPU refusal is the point here
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr
