"""Nothing the benchmark loads has the top-level name of JAX or of the JAX
package ``repro`` (compared by whole top-level name: ``repro_torch`` is the
port, not ``repro``)."""
import subprocess
import sys

from conftest import BENCH, ROOT

from harness import main

PROBE = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}, {str(BENCH / 'tests')!r}]
from pathlib import Path
import tempfile
from conftest import tiny_root
from harness import main, spec
root = tiny_root(Path(tempfile.mkdtemp()), moe=True, kind="closed_loop")
cell = spec.load_cell("tiny-cell", root)
run, params, _ = main.serve(cell, 3, 0.5, True, "cpu", time.perf_counter())
main.report(run, True)
main.judge(run, params, 3, "cpu")
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print(main.forbidden_modules())
"""


def test_a_run_loads_no_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         timeout=600, check=True).stdout.splitlines()
    loaded = eval(out[-2])
    assert "repro_torch" in loaded and "torch" in loaded
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)
    assert out[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert main.forbidden_modules() == ["repro"]


def test_benchmark_sources_import_no_jax():
    import ast

    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"jax", "jaxlib", "flax", "repro"}, path
