"""Shared by the port's model and serving tests (no test of its own): one
set of numpy-made parameters handed to both packages, and the stated
tolerances."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.policy import PRESETS as J_POLICIES
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.core.precision import Mode as JMode
from repro.models import build_model as j_build_model

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import NATIVE_F32, PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models.lm import DecodeState

#: One PyTorch intra-op thread per test process.  Tier-1 runs six pytest
#: workers on eight cores; with PyTorch's default pool (a thread per core)
#: in each, the many small operations of the smoke-size port tests spend
#: their time waiting for descheduled pool threads (measured: a test of
#: 0.3 s alone took 300 s under six workers).  Workers import this module
#: while collecting, so the setting holds in every worker.
torch.set_num_threads(1)

ARCH = "qwen1.5-0.5b"
FACTOR = 4.0
DECODE_STEPS = 8

POLICY_CASES = {
    # name: (port policy, reference policy, ceiling mode)
    "native_f32": (NATIVE_F32, J_POLICIES["native_f32"], Mode.M24),
    "M24": (PrecisionPolicy(default=Mode.M24), JPolicy(default=JMode.M24), Mode.M24),
    "M8": (PrecisionPolicy(default=Mode.M8), JPolicy(default=JMode.M8), Mode.M8),
}


def numpy_params(jmodel, seed: int):
    """The reference's parameter tree with every leaf drawn by numpy: weight
    matrices at Xavier scale, embeddings 0.02, norms and biases small."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "embed" in name:
            std = 0.02
        elif name.endswith("['w']"):
            std = (2.0 / (s.shape[-2] + s.shape[-1])) ** 0.5
        else:
            std = 0.05
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_pair(policy_name: str, kv_dtype: str = "bfloat16", seed: int = 0, *,
              arch: str = ARCH, **over):
    tpol, jpol, _ = POLICY_CASES[policy_name]
    jcfg = dataclasses.replace(j_get_smoke_config(arch).with_policy(jpol),
                               kv_cache_dtype=kv_dtype, **over)
    tcfg = dataclasses.replace(get_smoke_config(arch).with_policy(tpol),
                               kv_cache_dtype=kv_dtype, **over)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg, device="cpu")
    tree = numpy_params(jmodel, seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, device="cpu")
    return jmodel, jparams, tmodel, tparams


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def state_from_jax(jstate) -> DecodeState:
    """The reference's dense DecodeState (layers stacked on a leading axis)
    as the port's (a list with one KVCache per layer)."""
    c = jstate.caches["seg0_dense"]

    def conv(x, li, dtype=None):
        if x is None:
            return None
        t = torch.from_numpy(np.array(x[li], dtype=np.float32 if dtype else None))
        return t.to(dtype) if dtype else t

    kv_dtype = torch.int8 if c.k_scale is not None else torch.bfloat16
    layers = [
        tlayers.KVCache(conv(c.k, li, kv_dtype), conv(c.v, li, kv_dtype),
                        conv(c.k_scale, li), conv(c.v_scale, li),
                        conv(c.pos, li), conv(c.length, li))
        for li in range(c.k.shape[0])]
    return DecodeState(caches={"seg0_dense": layers},
                       position=torch.from_numpy(np.array(jstate.position)), enc_out=None)


#: share of one cache quantum (bf16: 2^-8 of a stored value, int8: 1/127 of a
#: row's largest) that reaches the logits when a stored K/V value which the
#: two frameworks computed an ulp apart rounds to different cache codes
CACHE_QUANTUM = {"bfloat16": 2.0**-8, "int8": 1.0 / 127}
CACHE_FLIP_SHARE = 0.25
#: most codes of one appended cache row that may round to a neighbouring
#: code when the two frameworks' values differ by their f32 arithmetic alone
#: (see ``test_prefill_and_decode_logits_vs_reference``)
APPENDED_FLIP_LIMIT_SHARE = 2.0**-6


def flat_numpy(tree_, prefix: str) -> dict:
    """A nested dict of numpy arrays as ``{prefix/a/b: array}`` (the
    checkpoint manager's keys)."""
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(flat_numpy(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree_)}


def spawn_ranks(scenario: str, world: int, d, timeout: float = 300.0) -> list[dict]:
    """Run ``tests/torch_dist_ranks.py scenario`` as ``world`` gloo ranks on
    the CPU (one process each, rendezvous through a FileStore in ``d``) and
    return each rank's JSON record; a rank that fails or outlives
    ``timeout`` fails the caller with its output."""
    import json
    import os
    import subprocess
    import sys
    import time

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(here), "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_dist_ranks.py"), scenario, str(r),
         str(world), str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    outs = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as fh:
            outs.append(json.load(fh))
    return outs


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """``chip_smoke.py`` as a module (loading it runs nothing)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_example(name: str):
    """The port arm ``examples/<name>_torch.py`` as a module, loaded as
    ``chip_smoke.py``'s ``examples`` phase loads it."""
    return chip_smoke().load_example(name)
