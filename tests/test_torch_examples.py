"""The port arms of ``examples/`` (``examples/*_torch.py``) on the CPU, held
against the reference's own library calls on the same numpy inputs: the
quickstart, the paper's 4x4 Strassen demo and batched serving (the training
arms are in ``test_torch_examples_train.py``).  The reference scripts are
not run: they execute at import, at fixed sizes.  Nothing here is cut: each
arm runs at the reference script's shapes, seeds and counts.

Tolerances:
  * matmul outputs: ``MATMUL_TOL`` (2e-6) of the reference result's scale,
    the bound the reference holds its own kernels to
    (``tests/test_kernels.py``);
  * served tokens against the reference's engine: the margin rule of
    ``test_torch_serve`` (a token is required to agree only where the
    reference's top-2 logit margin exceeds the logit tolerance; a request is
    compared up to its first undecided token).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as j_get_config
from repro.configs import paper_4x4 as j_paper_4x4
from repro.core import Mode as JMode
from repro.core import auto_mode as j_auto_mode
from repro.core import mp_matmul as j_mp_matmul
from repro.core import mp_matmul_runtime as j_mp_matmul_runtime
from repro.core.policy import PRESETS as J_POLICIES
from repro.core.strassen import leaf_products as j_leaf_products
from repro.core.strassen import strassen_matmul as j_strassen_matmul
from repro.models import build_model as j_build_model
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest

from repro_torch.convert import params_from_jax
from repro_torch.core.precision import Mode
from repro_torch.kernels import build
from repro_torch.plan import MODE_REL_ERROR

from test_torch_common import (
    CACHE_FLIP_SHARE,
    CACHE_QUANTUM,
    FACTOR,
    load_example,
    numpy_params,
)
from test_torch_serve import _margin_ok

MATMUL_TOL = 2e-6
ARMS = ("quickstart", "strassen_demo", "serve_batched", "train_lm", "autoprecision_train")


def _scale_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ARMS)
def test_arm_runs_on_the_gpu_or_raises(name):
    """Without ``--device`` an arm runs on the card; with no card it raises
    before it computes anything: it never falls back to the CPU."""
    if torch.cuda.is_available():
        return  # on a GPU the arm runs there (chip_smoke.py's examples phase)
    with pytest.raises(RuntimeError, match="found no GPU"):
        load_example(name).main([])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart():
    mod = load_example("quickstart")
    builds = build.BUILD_COUNT
    out = mod.main(["--device", "cpu"])
    assert build.BUILD_COUNT == builds == 0
    return mod, out


def test_quickstart_ladder_vs_reference(quickstart):
    mod, out = quickstart
    a, b, _ = mod.operands()
    for mode in mod.LADDER:
        want = j_mp_matmul(jnp.asarray(a), jnp.asarray(b), JMode[mode.name])
        for impl in ("xla", "pallas"):
            gap = _scale_gap(out["outputs"][mode.name][impl], want)
            assert gap <= MATMUL_TOL, (mode.name, impl, gap)
    for impl in ("xla", "pallas"):
        errs = [out["ladder"][m.name][impl] for m in mod.LADDER]
        assert errs[0] > errs[1] > errs[2], (impl, errs)
    assert [out["ladder"][m.name]["passes"] for m in mod.LADDER] == [1, 3, 6]


def test_quickstart_runtime_replays_equal_the_limb_kernel(quickstart):
    _, out = quickstart
    rt = out["runtime"]
    assert rt["bit_equal"] == {1: True, 2: True, 3: True}
    for bits, mode in ((1, "M8"), (2, "M16"), (3, "M24")):
        assert rt["rel_err"][bits] == out["ladder"][mode]["pallas"]
    # on the CPU the step runs eagerly through the plain versions
    assert (rt["graphs"], rt["replays"], rt["builds"], rt["tile_launches"]) == (0, 0, 0, 0)
    assert out["launches"] == {name: 0 for name in build.LAUNCHES}


def test_quickstart_auto_mode_and_integer_product_vs_reference(quickstart):
    mod, out = quickstart
    a, b, ai = (jnp.asarray(x) for x in mod.operands())
    assert out["auto"]["float"] == JMode(int(j_auto_mode(a, b))).name
    assert out["auto"]["int"] == JMode(int(j_auto_mode(ai, ai))).name
    ref = np.asarray(jax.jit(j_mp_matmul_runtime)(ai, ai, jnp.int32(0)), np.float64)
    ai64 = np.asarray(ai, np.float64)
    assert np.array_equal(ref, ai64 @ ai64)  # exact in the reference ...
    assert out["auto"]["int_exact"]  # ... and in the port


def test_quickstart_strassen_and_planner(quickstart):
    _, out = quickstart
    assert out["strassen"]["leaf_products"] == j_leaf_products(1) == 7
    assert out["strassen"]["rel_err"] < 2.0**-20
    assert out["strassen"]["m16_rel_err"] < 2.0**-15
    assert [(p["n"], p["mode"]) for p in out["plans"]] == [
        (256, "M8"), (4096, "M16"), (16384, "M24")]
    assert out["planned_rel_err"] < 2.0**-12


# ---------------------------------------------------------------------------
# the paper's 4x4 Strassen demo
# ---------------------------------------------------------------------------


def test_strassen_demo_vs_reference():
    mod = load_example("strassen_demo")
    out = mod.main(["--device", "cpu"])
    assert (out["matrix_size"], out["pe_size"], out["depth"]) == (
        j_paper_4x4.MATRIX_SIZE, j_paper_4x4.PE_SIZE, j_paper_4x4.STRASSEN_DEPTH)
    assert out["leaf_products"] == j_leaf_products(j_paper_4x4.STRASSEN_DEPTH) == 7
    a, b = (jnp.asarray(x) for x in mod.operands())
    exact = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    for mode in mod.LADDER:
        assert out["leaf_calls"][mode.name] == 7

        def leaf(x, y, m=JMode[mode.name]):
            return j_mp_matmul(x, y, m)

        want = j_strassen_matmul(a, b, depth=j_paper_4x4.STRASSEN_DEPTH, leaf_fn=leaf, align=2)
        scale = float(np.abs(np.asarray(want)).max())
        assert _scale_gap(out["outputs"][mode.name], want) <= MATMUL_TOL, mode.name
        ref_err = float(np.abs(np.asarray(want, np.float64) - exact).max())
        assert abs(out["max_abs_err"][mode.name] - ref_err) <= MATMUL_TOL * scale, mode.name
    errs = [out["max_abs_err"][m.name] for m in mod.LADDER]
    assert errs[0] > errs[1] > errs[2]


# ---------------------------------------------------------------------------
# batched serving
# ---------------------------------------------------------------------------


def _reference_model(mod, kv_dtype):
    cfg = dataclasses.replace(j_get_config("qwen1.5-0.5b"), kv_cache_dtype=kv_dtype,
                              **mod.SHAPE)
    return j_build_model(cfg.with_policy(J_POLICIES["native_f32"]))


def test_serve_batched_vs_reference_engine():
    """The arm from the reference's parameters (numpy draws): the streamed
    tokens equal the batch API's within the port, and both KV dtypes'
    tokens agree with the reference's engine under the margin rule."""
    mod = load_example("serve_batched")
    jmodel = _reference_model(mod, "bfloat16")
    tree = numpy_params(jmodel, 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    out = mod.main(["--device", "cpu"], params=params_from_jax(tree, device="cpu"))
    assert out["stream_equals_batch"] and out["batch"] == out["outputs"]["bfloat16"]
    assert out["graph_captures"] == 0  # the CPU runs the steps eagerly
    s = out["summary"]
    assert (s["requests"], s["completed"], s["tokens_out"]) == (6, 6, 6 * mod.MAX_NEW)
    assert sorted({rid for rid, _ in out["events"]}) == [0, 1, 2]  # three slots, 4 steps
    assert out["agree"] == sum(out["outputs"]["bfloat16"][r] == out["outputs"]["int8"][r]
                               for r in range(6))
    reqs = mod.requests()
    ceiling = MODE_REL_ERROR[Mode.M24]
    for kv_dtype in ("bfloat16", "int8"):
        jm = jmodel if kv_dtype == "bfloat16" else _reference_model(mod, kv_dtype)
        jeng = JServeEngine(jm, jparams, batch_slots=mod.SLOTS, max_len=mod.MAX_LEN)
        want = jeng.generate_batch([JRequest(r.prompt, r.max_new, rid=r.rid) for r in reqs])
        got = out["outputs"][kv_dtype]
        tol = ceiling * FACTOR + CACHE_QUANTUM[kv_dtype] * CACHE_FLIP_SHARE
        compared = decided = 0
        for r in reqs:
            assert len(got[r.rid]) == len(want[r.rid]) == mod.MAX_NEW
            margins = _margin_ok(jm, jparams, r.prompt, want[r.rid], tol)
            decided += int(margins.sum())
            for i, ok in enumerate(margins):
                if not ok:
                    break  # past an undecided token the streams may diverge
                assert got[r.rid][i] == want[r.rid][i], (kv_dtype, r.rid, i)
                compared += 1
        # the margin rule must leave most tokens decided at f32 fidelity (one
        # undecided first token takes a whole 12-token request out of the
        # comparison, so the share is counted over the decided tokens)
        assert decided >= 0.8 * len(reqs) * mod.MAX_NEW and compared > 0, (kv_dtype, decided)
