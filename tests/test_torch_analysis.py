"""repro_torch.analysis: each rule proven on a known-good and a known-bad
fixture (the bad fixture must fire exactly its own rule ID and nothing
else), the tile_policy re-export, the CLI gate, and the counterparts held
against the reference's ``repro.analysis`` where both can run on this CPU:
the dispatch counts of the run-time pmm paths, the rule catalogues, the
flow lattice and the report format.  (The reference's own ``TestFlow``
needs ``jax.experimental.enable_x64``, which jax 0.9.0 removed; the port's
flow rules need no x64 switch, so these run.)"""
import json
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import (
    Expect,
    Violation,
    analyze_flow,
    audit,
    audit_stats,
    dispatch_stats,
    format_report,
    lint_source,
    rule_ids,
    write_json,
)
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch import oprecord


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((32, 48)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((48, 16)).astype(np.float32))
    return a, b


# --------------------------------------------------------------------------
# precision-flow rules

class TestFlow:
    def test_f64_bad(self, mats):
        a, _ = mats
        # allowlist the widen so ONLY the f64 rule can fire
        v = analyze_flow(lambda x: x.to(torch.float64) * 2, a, path="p",
                         widen_allow=(("float32", "float64"),))
        assert rule_ids(v) == {"FLOW-F64"}

    def test_f64_good(self, mats):
        a, b = mats
        assert analyze_flow(lambda x, y: x @ y, a, b, path="p") == []

    def test_widen_bad(self, mats):
        a, _ = mats
        h = a.to(torch.float16)
        v = analyze_flow(lambda x: x.to(torch.float32) + 1, h, path="p")
        assert rule_ids(v) == {"FLOW-WIDEN"}

    def test_widen_good_limb_accumulation(self, mats):
        a, _ = mats
        h = a.to(torch.bfloat16)
        # bf16 -> f32 is the allowlisted accumulation edge
        assert analyze_flow(lambda x: x.to(torch.float32) + 1, h, path="p") == []

    def test_mode_bad_constant_folded(self, mats):
        a, _ = mats
        # the "mode" arg never reaches an op: Python folded it
        v = analyze_flow(lambda x, m: x * 2.0, a, torch.tensor(1, dtype=torch.int32),
                         path="p", mode_args=(1,))
        assert rule_ids(v) == {"FLOW-MODE"}

    def test_mode_bad_dtype(self, mats):
        a, _ = mats
        v = analyze_flow(lambda x, m: x * m, a, torch.tensor(1.0), path="p",
                         mode_args=(1,))
        assert rule_ids(v) == {"FLOW-MODE"}

    def test_mode_bad_read_back(self, mats):
        a, _ = mats
        # int(m) syncs: a captured step cannot read its mode back
        v = analyze_flow(lambda x, m: x * int(m.clamp(1, 3)), a,
                         torch.tensor(2, dtype=torch.int32), path="p", mode_args=(1,))
        assert rule_ids(v) == {"FLOW-MODE"}

    def test_mode_good_consumed(self, mats):
        a, _ = mats
        v = analyze_flow(lambda x, m: x * m.to(torch.float32), a,
                         torch.tensor(2, dtype=torch.int32), path="p", mode_args=(1,))
        assert v == []

    def test_mode_good_dict_with_inert_sites(self, mats):
        a, _ = mats
        # a ModeTable-style dict where only one site is consumed: fine —
        # unused leaves are inert arguments, not folded modes
        modes = {"used": torch.tensor(1, dtype=torch.int32),
                 "inert": torch.tensor(2, dtype=torch.int32)}
        v = analyze_flow(lambda x, m: x * m["used"].to(torch.float32), a, modes,
                         path="p", mode_args=(1,))
        assert v == []

    def test_narrow_bad_widening_impostor(self, mats):
        a, _ = mats
        h = a.to(torch.bfloat16)

        def quantize_mantissa_impostor(x):
            # charged as a quantize site, but it widens bf16 to f32
            with oprecord.suspended():
                y = x.to(torch.float32)
            oprecord.charge("quantize_mantissa_impostor", (x,), (y,))
            return y

        v = analyze_flow(lambda x: quantize_mantissa_impostor(x) + 0.0, h, path="p")
        assert rule_ids(v) == {"FLOW-NARROW"}

    def test_narrow_good_real_kernel(self, mats):
        from repro_torch.kernels.quantize_mantissa.ops import quantize_mantissa_op

        a, _ = mats
        assert analyze_flow(lambda x: quantize_mantissa_op(x, keep=8), a, path="p") == []

    def test_lattice_equals_the_reference(self):
        from repro.analysis import flow as jflow

        from repro_torch.analysis import flow

        assert flow.MANTISSA_BITS == jflow.MANTISSA_BITS
        assert flow.DEFAULT_WIDEN_ALLOW == jflow.DEFAULT_WIDEN_ALLOW


# --------------------------------------------------------------------------
# dispatch rules

def _runtime(impl):
    from repro_torch.core.rmpm import mp_matmul_runtime

    blk = (16, 16, 16)

    def fn(a, b, m):
        return mp_matmul_runtime(a, b, m, impl=impl, block=blk, allow_auto=False,
                                 device="cpu")
    return fn


class TestDispatch:
    def test_count_good(self, mats):
        a, b = mats
        v = audit(_runtime("tile"), (a, b, torch.tensor(2, dtype=torch.int32)),
                  Expect(exact={"switches": 0, "pallas_calls": 1}), "p")
        assert v == []

    def test_count_bad(self, mats):
        a, b = mats
        # the xla runtime path audited against the tile contract
        v = audit(_runtime("xla"), (a, b, torch.tensor(2, dtype=torch.int32)),
                  Expect(exact={"switches": 0, "pallas_calls": 1}), "p")
        assert rule_ids(v) == {"DISP-COUNT"}
        assert len(v) == 2  # one per failed counter

    def test_bounds(self, mats):
        a, b = mats
        stats = audit_stats(_runtime("xla"), a, b, torch.tensor(2, dtype=torch.int32))
        assert Expect(at_most={"switches": 1}).check(stats, "p") == []
        assert rule_ids(Expect(at_least={"pallas_calls": 1}).check(
            stats, "p")) == {"DISP-COUNT"}

    def test_densify_bad(self):
        pool = torch.zeros((64, 4, 8))
        idx = torch.zeros((2, 64), dtype=torch.int64)  # every row gathers the pool
        v = audit(lambda p, i: p[i], (pool, idx), Expect(densify_bytes=4 * 4 * 8 * 2 * 8), "p")
        assert rule_ids(v) == {"DISP-DENSIFY"}

    def test_densify_good(self):
        pool = torch.zeros((64, 4, 8))
        idx = torch.zeros((2, 8), dtype=torch.int64)  # 8 pages/row <= the cap
        v = audit(lambda p, i: p[i], (pool, idx), Expect(densify_bytes=4 * 4 * 8 * 2 * 8), "p")
        assert v == []

    def test_tile_policy_reexport_compat(self, mats):
        # the old import path, exactly two keys
        from repro_torch.kernels.tile_matmul import tile_policy

        assert tile_policy.dispatch_stats is dispatch_stats
        a, b = mats
        s = dispatch_stats(_runtime("tile"), a, b, torch.tensor(2, dtype=torch.int32))
        assert s == {"switches": 0, "pallas_calls": 1}

    @pytest.mark.parametrize("impl", ["xla", "tile"])
    def test_runtime_counts_equal_the_reference(self, mats, impl):
        import jax.numpy as jnp

        from repro.analysis import dispatch_stats as j_dispatch_stats
        from repro.core.rmpm import mp_matmul_runtime as j_runtime

        a, b = mats
        blk = (16, 16, 16)
        want = j_dispatch_stats(
            lambda a_, b_, m: j_runtime(a_, b_, m, impl=impl, block=blk, allow_auto=False),
            jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jnp.int32(2))
        got = dispatch_stats(_runtime(impl), a, b, torch.tensor(2, dtype=torch.int32))
        assert got == want


# --------------------------------------------------------------------------
# capture-hygiene linter

def _ids(src, path="src/repro_torch/x.py"):
    return rule_ids(lint_source(textwrap.dedent(src), path))


class TestLint:
    def test_th001_bad_host_branch(self):
        assert _ids("""
            class Engine:
                def __init__(self):
                    self._g = CompiledStep(self._body, "cuda", name="step")
                def _body(self):
                    return self._step(self._tokens)
                def _step(self, tokens):
                    if tokens.sum() > 0:
                        return tokens
                    return -tokens
            """) == {"TH001"}

    def test_th001_bad_ifexp_module_function(self):
        # a captured module-level function, reached by name
        assert _ids("""
            def step(x):
                return x if x.sum() > 0 else -x
            def body():
                return step(X)
            graph = graphs.CompiledStep(body, "cuda", name="step")
            """) == {"TH001"}

    def test_th001_bad_while_in_captured_body(self):
        assert _ids("""
            class Engine:
                def _masked_step(self, tokens, state):
                    while tokens > 0:
                        tokens = tokens - 1
                    return state
                def __init__(self):
                    self._step = CompiledStep(self._masked_step, "cuda", name="s")
            """) == {"TH001"}

    def test_th001_good_metadata_and_static(self):
        assert _ids("""
            class Engine:
                def __init__(self):
                    self._g = CompiledStep(self._step, "cuda", name="s")
                def _step(self, x, ax: int, rounding="rne"):
                    if x.ndim < 2:
                        x = x.reshape(1, -1)
                    if rounding != "rne":
                        x = x + 1
                    if ax < 0:
                        return x
                    if x is None:
                        return None
                    y = x if x.dim() == 2 else x[None]
                    return y
            """) == set()

    def test_th001_good_not_captured(self):
        # the same branch outside a captured body is eager host code
        assert _ids("""
            def step(x):
                if x.sum() > 0:
                    return x
                return -x
            """) == set()

    def test_th002_bad_wallclock(self):
        assert _ids("""
            import time
            def span():
                t0 = time.time()
                return time.time() - t0
            """) == {"TH002"}

    def test_th002_allowlisted_stamp(self):
        src = """
            import time
            def manifest():
                return {"time": time.time()}
            """
        assert _ids(src, path="src/repro_torch/checkpoint/manager.py") == set()
        assert _ids(src) == {"TH002"}

    def test_th003_bad_numpy_on_tensor(self):
        assert _ids("""
            import numpy as np
            class E:
                def __init__(self):
                    self._g = CompiledStep(self._s, "cuda", name="s")
                def _s(self, x):
                    return np.sum(x)
            """) == {"TH003"}

    def test_th003_bad_coercion(self):
        assert _ids("""
            class E:
                def __init__(self):
                    self._g = CompiledStep(self._s, "cuda", name="s")
                def _s(self, x):
                    return float(x)
            """) == {"TH003"}

    def test_th003_bad_item(self):
        assert _ids("""
            class E:
                def __init__(self):
                    self._g = CompiledStep(self._s, "cuda", name="s")
                def _s(self, x):
                    return x.max().item()
            """) == {"TH003"}

    def test_th003_good_numpy_on_metadata(self):
        assert _ids("""
            import numpy as np
            class E:
                def __init__(self):
                    self._g = CompiledStep(self._s, "cuda", name="s")
                def _s(self, x):
                    n = np.prod(x.shape)
                    return x * n
            """) == set()

    def test_th004_bad_probe_in_capture(self):
        assert _ids("""
            import torch
            class E:
                def __init__(self):
                    self._g = CompiledStep(self._s, "cuda", name="s")
                def _s(self, x):
                    dev = resolve_device(None)
                    return x.to(dev) if torch.cuda.is_available() else x
            """) == {"TH004"}

    def test_th004_good_shell_resolution(self):
        assert _ids("""
            class E:
                def __init__(self, device=None):
                    self.device = resolve_device(device)
                    self._g = CompiledStep(self._s, self.device, name="s")
                def _s(self):
                    return self._x * 2
            """) == set()

    def test_th005_bad_mutable_default_arg(self):
        assert _ids("""
            def f(x, acc=[]):
                acc.append(x)
                return acc
            """) == {"TH005"}

    def test_th005_bad_dataclass_field(self):
        assert _ids("""
            import dataclasses
            @dataclasses.dataclass
            class Config:
                xs: list = []
            """) == {"TH005"}

    def test_th005_good_default_factory(self):
        assert _ids("""
            import dataclasses
            @dataclasses.dataclass
            class Config:
                xs: list = dataclasses.field(default_factory=list)
            def f(x, acc=None):
                return acc
            """) == set()

    def test_rules_and_allowlist_match_the_reference(self):
        from repro.analysis import lint as jlint

        from repro_torch.analysis import lint

        assert set(lint.RULES) == set(jlint.RULES)
        assert lint.ALLOWLIST == jlint.ALLOWLIST

    def test_port_src_is_clean(self):
        from repro_torch.analysis import lint_paths
        from repro_torch.analysis.__main__ import _default_src

        violations, files = lint_paths(_default_src())
        assert files, "linter found no files — wrong root?"
        assert any(f.endswith("serve/engine.py") for f in files)
        assert violations == [], [v.format() for v in violations]

    def test_engine_captured_bodies_are_found(self):
        import ast

        from repro_torch.analysis.__main__ import _default_src
        from repro_torch.analysis.lint import _captured_functions

        with open(f"{_default_src()}/serve/engine.py") as fh:
            names = {fn.name for fn, _ in _captured_functions(ast.parse(fh.read()))}
        assert {"_plain_step_body", "_modal_step_body", "_probe_body", "_spec_round_body",
                "_masked_step", "_masked_step_modal"} <= names


# --------------------------------------------------------------------------
# report + CLI

class TestReport:
    def test_format_and_json(self, tmp_path):
        v = [Violation("TH002", "a.py:3", "wall clock")]
        text = format_report(v, ["a.py"])
        assert "TH002 @ a.py:3" in text and "1 violation" in text
        out = tmp_path / "r.json"
        write_json(str(out), v, ["a.py"])
        doc = json.loads(out.read_text())
        assert doc["clean"] is False
        assert doc["violations"][0]["rule"] == "TH002"

    def test_json_equals_the_reference(self, tmp_path):
        from repro.analysis import Violation as JViolation
        from repro.analysis import write_json as j_write_json

        write_json(str(tmp_path / "a.json"), [Violation("TH002", "a.py:3", "m")], ["a.py"])
        j_write_json(str(tmp_path / "b.json"), [JViolation("TH002", "a.py:3", "m")], ["a.py"])
        assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()

    def test_cli_lint_only_bad_tree(self, tmp_path):
        bad = tmp_path / "mod.py"
        bad.write_text("import time\nT0 = time.time()\n")
        rc = analysis_main(["--skip-paths", "--src", str(tmp_path),
                            "--report", str(tmp_path / "r.json")])
        assert rc == 1
        doc = json.loads((tmp_path / "r.json").read_text())
        assert [v["rule"] for v in doc["violations"]] == ["TH002"]

    def test_cli_lint_only_clean_tree(self, tmp_path):
        (tmp_path / "mod.py").write_text("X = 1\n")
        assert analysis_main(["--skip-paths", "--src", str(tmp_path)]) == 0

    def test_cli_quick_clean(self, tmp_path):
        # `python -m repro_torch.analysis --quick --device cpu`: the port's lint + kernel
        # and train hot paths satisfy their contracts, exit 0
        import os
        import subprocess
        import sys

        src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--quick", "--device", "cpu", "--report",
             str(tmp_path / "r.json")], capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
        assert "0 violation(s)" in out.stdout
        doc = json.loads((tmp_path / "r.json").read_text())
        assert doc["clean"] is True
        assert "pmm-runtime-tile" in doc["checked"]
        assert "train-step" in doc["checked"]
        assert any(c.startswith("lint:") for c in doc["checked"])


def test_engine_paths_clean():
    from repro_torch.analysis.hotpaths import check, engine_paths

    violations, names = check(engine_paths("cpu"))
    assert len(names) == 14
    assert violations == [], [v.format() for v in violations]


def test_all_paths_default_is_the_gpu(monkeypatch):
    # the registry, like every entry point of the port, runs on the GPU unless
    # the caller asks for the CPU, and raises when there is no GPU
    import torch

    from repro_torch.analysis.hotpaths import all_paths

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        all_paths(quick=True)
