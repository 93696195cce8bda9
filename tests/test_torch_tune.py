"""Port vs reference, the autotuner (repro_torch.tune) and the planner's
tuning-table resolution: the table's JSON round trip and schema check, the
reference's committed ``tuning/cpu.json`` loaded by the port and planned
from identically, resolution precedence (exact hit > scaled neighbor >
roofline on the table's fitted balance), the TUNE_TABLE env var / path /
``False`` plumbing, and the tuner CLI feeding the planner — on the CPU."""
import json
import os

import pytest

from repro.plan import clear_plan_cache as j_clear_plan_cache
from repro.plan import plan_matmul as j_plan_matmul
from repro.plan import set_tune_table as j_set_tune_table
from repro.tune import TuneTable as JTuneTable

from repro_torch.configs import get_smoke_config
from repro_torch.core.precision import Mode
from repro_torch.plan import (
    DEFAULT_BALANCE,
    NATIVE_REL_ERROR,
    active_tune_table,
    cheapest_mode,
    clear_plan_cache,
    plan_matmul,
    plan_model_policy,
    set_tune_table,
)
from repro_torch.tune import (
    SCHEMA_VERSION,
    TuneRecord,
    TuneTable,
    candidates,
    mode_key,
    tune,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
COMMITTED_TABLE = os.path.join(REPO, "tuning", "cpu.json")
ACCURACIES = (2.0**-4, 2.0**-12, 2.0**-20, None)


@pytest.fixture(autouse=True)
def _fresh_planners(monkeypatch):
    monkeypatch.delenv("TUNE_TABLE", raising=False)
    for reset in (set_tune_table, j_set_tune_table):
        reset(None)
    clear_plan_cache()
    j_clear_plan_cache()
    yield
    for reset in (set_tune_table, j_set_tune_table):
        reset(None)
    clear_plan_cache()
    j_clear_plan_cache()


def _rec(m, k, n, mode, impl, depth, wall_us, block=None):
    return TuneRecord(m=m, k=k, n=n, mode=mode_key(mode, impl), impl=impl, depth=depth,
                      wall_us=wall_us, flops_per_s=2.0 * m * k * n / (wall_us * 1e-6),
                      max_abs_err=1e-3, rel_err=1e-6, block=block, iters=1)


def _synthetic_table():
    # measurement says native is 100x faster than the roofline's xla pick
    return TuneTable(backend="cpu", records=(
        _rec(256, 256, 256, Mode.M24, "native", 0, 10.0),
        _rec(256, 256, 256, Mode.M8, "xla", 0, 1000.0),
    ))


def _key(p):
    return (int(p.mode), p.impl, p.strassen_depth, p.block)


class TestTable:
    def test_save_load_identity_and_fingerprint(self, tmp_path):
        table = TuneTable(
            backend="gpu",
            records=(_rec(128, 128, 128, Mode.M8, "xla", 0, 100.0),
                     _rec(128, 128, 128, Mode.M16, "pallas", 0, 50.0, block=(128, 128, 128))),
            torch_version="0.0.test", iters=3)
        path = tmp_path / "t.json"
        table.save(str(path))
        loaded = TuneTable.load(str(path))
        assert loaded == table and loaded.fingerprint == table.fingerprint
        assert loaded.records[1].block == (128, 128, 128)
        doc = json.loads(path.read_text())
        assert doc["schema_version"] == SCHEMA_VERSION == 1
        assert doc["torch_version"] == "0.0.test" and "jax_version" not in doc

    def test_schema_version_enforced(self, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps({"schema_version": 999, "backend": "cpu", "records": []}))
        with pytest.raises(ValueError, match="schema_version"):
            TuneTable.load(str(path))

    def test_reference_table_loads_unchanged(self):
        ours, theirs = TuneTable.load(COMMITTED_TABLE), JTuneTable.load(COMMITTED_TABLE)
        assert ours.backend == theirs.backend == "cpu"
        assert [r.to_json() for r in ours.records] == [r.to_json() for r in theirs.records]
        assert (ours.balance.peak_flops, ours.balance.hbm_bw) == (
            theirs.balance.peak_flops, theirs.balance.hbm_bw)
        assert ours.balance.f32_flops is None  # 'native' ranks at the fitted peak too

    def test_lookup_prefers_fastest_block_and_nearest_is_bounded(self):
        table = TuneTable(backend="gpu", records=(
            _rec(256, 256, 256, Mode.M16, "pallas", 0, 90.0, block=(128, 128, 128)),
            _rec(256, 256, 256, Mode.M16, "pallas", 0, 40.0, block=(128, 128, 512)),
        ))
        assert table.lookup(256, 256, 256, Mode.M16, "pallas", 0).block == (128, 128, 512)
        rec, ratio = table.nearest(512, 512, 512, Mode.M16, "pallas", 0)
        assert rec.m == 256 and ratio == pytest.approx(8.0)
        assert table.nearest(16384, 16384, 16384, Mode.M16, "pallas", 0) is None


# ---------------------------------------------------------------------------
# the reference's committed table: the port plans from it as the reference does
# ---------------------------------------------------------------------------


def _table_sizes():
    with open(COMMITTED_TABLE) as fh:
        return sorted({r["m"] for r in json.load(fh)["records"]})


@pytest.mark.parametrize("max_depth", [0, 1])
@pytest.mark.parametrize("n", _table_sizes())
def test_plans_from_the_reference_table_equal_the_reference(n, max_depth):
    jt, tt = JTuneTable.load(COMMITTED_TABLE), TuneTable.load(COMMITTED_TABLE)
    hits = 0
    for acc in ACCURACIES:
        kw = dict(accuracy=acc, backend="cpu", max_depth=max_depth)
        want = j_plan_matmul((n, n), (n, n), tune_table=jt, **kw)
        got = plan_matmul((n, n), (n, n), tune_table=tt, **kw)
        assert got.source == want.source
        if want.source == "measured":
            hits += 1
            assert _key(got) == _key(want), (acc, _key(got), _key(want))
            assert got.t_resolved_s == pytest.approx(want.t_resolved_s)
            assert "cost measured (table" in got.reason
    assert hits > 0


# ---------------------------------------------------------------------------
# resolution precedence
# ---------------------------------------------------------------------------


class TestResolutionPrecedence:
    def test_exact_hit_overrides_roofline(self):
        base = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu",
                           tune_table=False)
        tuned = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu",
                            tune_table=_synthetic_table())
        assert base.impl == "xla" and base.source == "roofline"
        assert tuned.impl == "native" and tuned.source == "measured"
        assert tuned.t_resolved_s == pytest.approx(10e-6)

    def test_neighbor_interpolates_when_no_exact_hit(self):
        tuned = plan_matmul((320, 256), (256, 256), accuracy=2**-4, backend="cpu",
                            tune_table=_synthetic_table())
        assert tuned.source == "interpolated" and tuned.impl == "native"
        assert tuned.t_resolved_s == pytest.approx(10e-6 * 320 / 256)

    def test_roofline_fallback_runs_on_the_fitted_balance(self):
        table = _synthetic_table()
        base = plan_matmul((16384, 16384), (16384, 16384), accuracy=2**-4,
                           backend="cpu", tune_table=False)
        tuned = plan_matmul((16384, 16384), (16384, 16384), accuracy=2**-4,
                            backend="cpu", tune_table=table)
        assert tuned.source == "roofline" and "fit:cpu" in tuned.reason
        assert table.balance.peak_flops != DEFAULT_BALANCE.peak_flops
        assert tuned.cost.t_total_s != base.cost.t_total_s

    def test_backend_mismatch_ignores_table(self):
        tuned = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="gpu",
                            tune_table=_synthetic_table())
        assert tuned.source == "roofline" and "H100 SXM data sheet" in tuned.reason

    def test_table_fingerprint_in_plan_cache_key(self):
        base = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu")
        tuned = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu",
                            tune_table=_synthetic_table())
        assert base is not tuned and base.impl != tuned.impl

    def test_gpu_table_can_pick_the_mode_map_kernel(self):
        table = TuneTable(backend="gpu", records=(
            _rec(1024, 1024, 1024, Mode.M16, "pallas", 0, 90.0, block=(128, 128, 512)),
            _rec(1024, 1024, 1024, Mode.M16, "tile", 0, 60.0, block=(128, 128, 128)),
            _rec(1024, 1024, 1024, Mode.M16, "xla", 0, 500.0),
            _rec(1024, 1024, 1024, Mode.M24, "native", 0, 200.0),
        ))
        p = plan_matmul((1024, 1024), (1024, 1024), accuracy=2**-12, backend="gpu",
                        max_depth=0, tune_table=table)
        assert (p.impl, p.block, p.source) == ("tile", (128, 128, 128), "measured")

    def test_bad_table_argument_raises(self):
        with pytest.raises(TypeError, match="tune_table must be"):
            plan_matmul((64, 64), (64, 64), backend="cpu", tune_table=object())
        with pytest.raises(TypeError, match="a tuning table is"):
            set_tune_table(42)


class TestOverridePlumbing:
    def test_default_loads_no_table(self):
        assert active_tune_table("cpu") is None
        p = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu")
        assert p.source == "roofline"

    def test_env_var_file(self, tmp_path, monkeypatch):
        path = tmp_path / "cpu.json"
        _synthetic_table().save(str(path))
        monkeypatch.setenv("TUNE_TABLE", str(path))
        set_tune_table(None)  # drop the resolved-empty cache; re-read the env
        p = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu")
        assert p.source == "measured" and p.impl == "native"

    def test_env_var_directory(self, tmp_path, monkeypatch):
        _synthetic_table().save(str(tmp_path / "cpu.json"))
        monkeypatch.setenv("TUNE_TABLE", str(tmp_path))
        set_tune_table(None)
        assert plan_matmul((256, 256), (256, 256), accuracy=2**-4,
                           backend="cpu").source == "measured"
        assert plan_matmul((256, 256), (256, 256), accuracy=2**-4,
                           backend="gpu").source == "roofline"

    def test_set_tune_table_explicit(self):
        set_tune_table(_synthetic_table())
        assert plan_matmul((256, 256), (256, 256), accuracy=2**-4,
                           backend="cpu").source == "measured"
        set_tune_table(None)
        assert plan_matmul((256, 256), (256, 256), accuracy=2**-4,
                           backend="cpu").source == "roofline"

    def test_arg_false_forces_roofline(self, tmp_path, monkeypatch):
        path = tmp_path / "cpu.json"
        _synthetic_table().save(str(path))
        monkeypatch.setenv("TUNE_TABLE", str(path))
        set_tune_table(None)
        p = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu",
                        tune_table=False)
        assert p.source == "roofline"

    def test_path_arg_and_rewrite_invalidates(self, tmp_path):
        path = tmp_path / "anywhere.json"
        _synthetic_table().save(str(path))
        p = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu",
                        tune_table=str(path))
        assert p.source == "measured" and p.impl == "native"
        TuneTable(backend="cpu", records=(  # rewritten: native is now slower
            _rec(256, 256, 256, Mode.M24, "native", 0, 5000.0),
            _rec(256, 256, 256, Mode.M8, "xla", 0, 1000.0),
        )).save(str(path))
        q = plan_matmul((256, 256), (256, 256), accuracy=2**-4, backend="cpu",
                        tune_table=str(path))
        assert q.impl == "xla"

    def test_plan_model_policy_plumbs_table(self):
        cfg = get_smoke_config("qwen1.5-0.5b")
        policy, plans = plan_model_policy(cfg, tokens=256, accuracy=2**-4, backend="cpu",
                                          tune_table=TuneTable.load(COMMITTED_TABLE))
        assert any(p.source in ("measured", "interpolated") for p in plans.values())

    def test_engine_plans_both_phases_from_the_table(self):
        from repro_torch.models import build_model
        from repro_torch.serve import ServeConfig, ServeEngine

        model = build_model(get_smoke_config("qwen1.5-0.5b"), device="cpu")
        eng = ServeEngine(model, model.init(0), config=ServeConfig(
            batch_slots=2, max_len=32, accuracy=2**-4, tune_table=COMMITTED_TABLE))
        sources = {p.source for p in eng.plans.values()}
        assert sources <= {"measured", "interpolated", "roofline"}
        assert sources & {"measured", "interpolated"}
        assert "(table " in eng.describe_plans()


# ---------------------------------------------------------------------------
# the runner and the CLI
# ---------------------------------------------------------------------------


class TestRunner:
    def test_candidate_space_is_the_planners_per_backend(self):
        gpu = {c.impl for c in candidates(256, 256, 256, "gpu")}
        cpu = {c.impl for c in candidates(256, 256, 256, "cpu")}
        assert gpu == {"native", "xla", "pallas", "tile"} and cpu == {"native", "xla"}
        # no 1-limb fused-extraction candidate, as in the planner
        assert not [c for c in candidates(256, 256, 256, "gpu")
                    if c.impl == "pallas" and c.mode == Mode.M8]
        assert {c.depth for c in candidates(256, 256, 256, "gpu")} == {0, 1}

    def test_defaults_to_the_gpu(self):
        import torch

        if torch.cuda.is_available():
            return  # on a GPU the tuner measures there; the CPU refusal is the point here
        with pytest.raises(RuntimeError, match="found no GPU"):
            tune((64,), iters=1)

    def test_cli_table_feeds_planner(self, tmp_path, capsys):
        from repro_torch.tune.__main__ import main

        out = tmp_path / "t.json"
        main(["--sizes", "64", "--iters", "1", "--backend", "cpu", "--out", str(out)])
        assert "fingerprint" in capsys.readouterr().out
        doc = json.loads(out.read_text())
        assert doc["schema_version"] == SCHEMA_VERSION and doc["backend"] == "cpu"
        assert {r["impl"] for r in doc["records"]} == {"native", "xla"}
        assert all(r["rel_err"] < 2**-6 for r in doc["records"])
        table = TuneTable.load(str(out))
        for acc in (2.0**-4, 2.0**-12, 2.0**-20):
            tuned = plan_matmul((64, 64), (64, 64), accuracy=acc, backend="cpu",
                                tune_table=table)
            assert tuned.source == "measured"
            mode = cheapest_mode(acc)
            impls = (["native"] if NATIVE_REL_ERROR <= acc else []) + ["xla"]
            walls = {impl: table.lookup(64, 64, 64, mode, impl, 0).wall_us for impl in impls}
            assert walls[tuned.impl] == min(walls.values())
