"""The port's dry run (``repro_torch.launch.shapes`` / ``dryrun``) against the
reference's: the cells' tables, stand-in shapes and dtypes for all ten archs
x four shapes, parameter counts and MODEL_FLOPS at full size (shapes only,
nothing allocated), the counterpart of ``test_dryrun_cell_on_8_devices`` (a
4x2 fake mesh) and one ``run_cell`` record at the smoke size on the
production mesh.  Fake process groups run in a subprocess (one PyTorch
thread, 300 s at most), so none outlives a test."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.launch import shapes as jshapes

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE_NAMES = tuple(jshapes.SHAPES)
#: the reference's record keys (``run_cell``), with the port's trace time in
#: place of its lower / compile times
RECORD_KEYS = {"cell", "arch", "shape", "mesh", "policy", "chips", "status", "memory",
               "roofline", "params", "model_flops_global", "useful_flops_ratio",
               "roofline_fraction_estimate", "t_trace_s"}
ROOFLINE_KEYS = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device",
                 "collective_breakdown"}


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_tables_equal_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: (v.name, v.kind, v.seq, v.batch) for k, v in shapes.SHAPES.items()} == {
        k: (v.name, v.kind, v.seq, v.batch) for k, v in jshapes.SHAPES.items()}
    assert shapes.ACCUM == jshapes.ACCUM


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_and_input_specs_equal_the_reference(arch):
    for name in SHAPE_NAMES:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        shape, jshape = shapes.SHAPES[name], jshapes.SHAPES[name]
        assert shapes.cell_applicable(cfg, shape) == jshapes.cell_applicable(jcfg, jshape)
        tw, jtw = shapes._arch_tweaks(cfg, shape), jshapes._arch_tweaks(jcfg, jshape)
        assert (tw.moe_group_size, tw.attn_chunk) == (jtw.moe_group_size, jtw.attn_chunk)
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""), v.device.type)
               for k, v in shapes.input_specs(cfg, shape).items()}
        want = {k: (tuple(v.shape), str(v.dtype), "meta")
                for k, v in jshapes.input_specs(jcfg, jshape).items()}
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    from repro.models import build_model as j_build_model

    cfg, jcfg = get_config(arch), j_get_config(arch)
    params = shapes.param_specs(cfg)
    assert all(x.device.type == "meta" for x in jax.tree.leaves(params))
    jparams = jax.eval_shape(j_build_model(jcfg).init, jax.random.key(0))
    assert shapes.count_params(params, cfg) == jshapes.count_params(jparams, jcfg)
    for name in SHAPE_NAMES:
        assert shapes.model_flops(cfg, shapes.SHAPES[name], params) == jshapes.model_flops(
            jcfg, jshapes.SHAPES[name], jparams), name


def test_import_makes_no_process_group_and_sets_no_environment():
    out = _run("""
        import os, json
        before = dict(os.environ)
        import torch.distributed as dist
        import repro_torch.launch.dryrun
        print(json.dumps([dist.is_initialized(), dict(os.environ) == before]))
    """)
    assert json.loads(out.strip().splitlines()[-1]) == [False, True]


def test_dryrun_cell_on_8_devices():
    # the dry-run machinery on a small mesh: proves it is device-count independent
    out = _run("""
        import torch
        torch.set_num_threads(1)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.dryrun import fake_world, trace_cell
        from repro_torch.launch.shapes import ShapeSpec, build_cell
        cfg = get_smoke_config("qwen1.5-0.5b")
        with fake_world(8):
            mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
            cell = build_cell(cfg, ShapeSpec("t", "train", 64, 8), mesh)
            rec, memory, _ = trace_cell(cell, mesh)
        assert rec.cost.flops > 0 and rec.cost.collective_bytes > 0
        assert memory["argument_bytes"] > 0 and memory["temp_bytes"] > 0
        print("flops/dev:", rec.cost.flops)
    """)
    assert "flops/dev:" in out


def test_run_cell_record_at_smoke_size(tmp_path):
    out = _run(f"""
        import json, torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell("qwen1.5-0.5b", "decode_32k", False, out_dir={str(tmp_path)!r},
                       smoke=True)
        assert not dist.is_initialized()
        print(json.dumps(rec, default=str))
    """)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec.get("error")
    assert RECORD_KEYS <= set(rec)
    assert ROOFLINE_KEYS <= set(rec["roofline"])
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes"}
    assert (rec["mesh"], rec["chips"]) == ("pod16x16", 256)
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["roofline"]["collective_bytes_per_device"] > 0
    assert json.loads((tmp_path / (rec["cell"] + ".json")).read_text())["status"] == "ok"


def test_run_cells_records_every_cell_its_own_way(tmp_path):
    """``run_cells`` (the CLI's ``--jobs`` runner, which chip_smoke's ``cost``
    phase also drives): a cell a shape does not apply to records ``n/a``, a
    cell stopped at its timeout ``timeout``, each read back in order of
    finishing, with each cell's output beside its record."""
    from repro_torch.launch.dryrun import run_cells

    env = {"PYTHONPATH": os.path.join(ROOT, "src")}
    recs = run_cells([("qwen1.5-0.5b", "long_500k", False)], jobs=2, policy="native_f32",
                     out=str(tmp_path), cell_timeout=280, env=env)
    assert [(r["cell"], r["status"]) for r in recs] == [
        ("qwen1.5-0.5b__long_500k__pod16x16__native_f32", "n/a")]
    recs = run_cells([("qwen1.5-0.5b", "train_4k", True)], jobs=2, policy="native_f32",
                     out=str(tmp_path), cell_timeout=0.1, env=env)
    assert [(r["cell"], r["status"], r["chips"]) for r in recs] == [
        ("qwen1.5-0.5b__train_4k__pod2x16x16__native_f32", "timeout", 512)]
    on_disk = json.loads((tmp_path / (recs[0]["cell"] + ".json")).read_text())
    assert on_disk == recs[0]
    assert (tmp_path / (recs[0]["cell"] + ".log")).exists()
