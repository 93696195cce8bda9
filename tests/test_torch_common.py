"""Shared by the port's model and serving tests (no test of its own): one
set of numpy-made parameters handed to both packages, and the stated
tolerances."""
import dataclasses

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


def make_pair(policy_name: str, kv_dtype: str = "bfloat16", seed: int = 0, **over):
    tpol, jpol, _ = POLICY_CASES[policy_name]
    jcfg = dataclasses.replace(j_get_smoke_config(ARCH).with_policy(jpol),
                               kv_cache_dtype=kv_dtype, **over)
    tcfg = dataclasses.replace(get_smoke_config(ARCH).with_policy(tpol),
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
#: the same for a step that starts from the reference's cache: only the row
#: the step itself appends (and reads back) can round differently
CACHE_FLIP_SHARE_ONE_ROW = 2.0**-10
