"""Nothing the benchmark loads has the top-level name of JAX or of the JAX
package ``repro`` (compared by whole top-level name: ``repro_torch`` is the
port, not ``repro``); the plain references load nothing of the port; and
the harness names no family."""
import re
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


REFERENCE_PROBE = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
from harness import spec
mod = spec._module(spec.Path(sys.argv[1]))
assert hasattr(mod, "Replay") or mod.__name__.endswith("__init__"), mod
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def reference_modules():
    return [p for p in sorted((BENCH / "reference").glob("*.py"))
            + sorted((BENCH / "tests" / "families").glob("*.py"))
            if not p.stem.endswith("_arch")]


def test_reference_modules_load_nothing_of_the_port():
    """Each family's reference, loaded alone in a fresh interpreter (its
    ``<family>_arch.py`` mapping to the port's ``ArchConfig`` aside)."""
    paths = reference_modules()
    assert {p.name for p in paths} >= {"__init__.py", "gqa.py", "dense_then_moe.py"}
    for path in paths:
        out = subprocess.run([sys.executable, "-c", REFERENCE_PROBE, str(path)],
                             capture_output=True, text=True, timeout=300, check=True)
        loaded = set(eval(out.stdout.splitlines()[-1]))
        assert "torch" in loaded or path.name == "__init__.py", path
        assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & loaded, path


#: the files that serve every family: none may name one, test a family's
#: field or import a family's module
GENERIC = ["harness/*.py", "metrics/*.py", "run.py", "readings.py", "sweep.py", "spans.py",
           "faults.py", "traffic/kinds/*.py"]


def test_the_harness_names_no_family():
    bad = re.compile(r"\breference\.\w|from reference|import reference|\.moe\b|seg\d+_|\bgqa\b")
    files = [p for pattern in GENERIC for p in sorted(BENCH.glob(pattern))]
    assert len(files) > 20
    for path in files:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not bad.search(line), f"{path}:{i}: {line}"
