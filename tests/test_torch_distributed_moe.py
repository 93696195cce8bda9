"""The MoE layer over a mesh on the CPU: four gloo ranks
(``torch_dist_ranks.py moe``, which imports neither JAX nor the reference)
run Phi-3.5-MoE and Kimi-K2 (a dense first layer and a shared expert) at
their smoke sizes and ``native_f32`` on a (2, 2) ('data', 'model') mesh:
experts over 'model', their D or F over 'data' (ZeRO-3), routing groups
with the batch rows.

The layer alone, on the same inputs both ways, is the unsharded layer:
its output and the input's gradient bit for bit, the same expert ids and
slots, the weights' gradients within ``GRAD_TOL`` (2^-14 of scale: their
f32 sums over the rows run in another order).  Over the whole model the
attention's sums over 'model' differ from the unsharded ones in the last
f32 bits, and the MoE layer's bf16 rounding points (tokens, combine
weights, expert outputs, the combine's sum) turn such a difference into a
bf16 code flip now and then, which moves that value by 2^-8 of itself: the
bound of ``test_torch_train.py``'s MoE family, ``GRAD_TOL_MOE`` (2^-7),
holds each gradient leaf and the gradient norm (measured up to 4.0e-3 and
1.1e-4).  The loss is held to the reference's own bound for a sharded step,
``SHARDED_LOSS_TOL`` (5e-4; measured up to 6.7e-6), each step against the
unsharded step from the same state (AdamW's first update moves an element
by ~lr whatever its gradient, so where a flip turns a tiny gradient's sign
two runs part by 2 lr: their next losses differed by up to 8.9e-4), and the
first against the reference's jitted single-device step to ``LOSS_TOL``
(1e-5 relative).  Cached decode
at B = 4 groups each step's four rows into one routing group across the
two 'data' ranks (the reference's capacity ``capacity_for(4)`` = 2); its
logits are held to ``DECODE_TOL`` as ``test_torch_distributed_shardwise.py``
holds the dense archs', with the expert ids and slots of every step equal
to the unsharded run's, and the test data is such that two groups of each
rank's own rows (capacity 1) would keep fewer assignments.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.policy import PRESETS as J_POLICIES
from repro.models import build_model as j_build_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep

from test_torch_common import flat_numpy, numpy_params, spawn_ranks

SHARDED_LOSS_TOL = 5e-4
LOSS_TOL = 1e-5
GRAD_TOL = 2.0**-14
GRAD_TOL_MOE = 2.0**-7
DECODE_TOL = 2.0**-8
WORLD = 4
ARCHS = {"phi": "phi3.5-moe-42b-a6.6b", "kimi": "kimi-k2-1t-a32b"}
#: MoE layers of each smoke arch (Kimi-K2's first layer is dense)
MOE_LAYERS = {"phi": 4, "kimi": 3}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's jitted step of each arch here; the ranks' records."""
    d = tmp_path_factory.mktemp("moe")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (8, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    inputs = dict(batch, moe_x=rng.standard_normal((4, 64, 128)).astype(np.float32),
                  moe_probe=rng.standard_normal(128).astype(np.float32))
    ref = {}
    tcfg = jstep.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-3, warmup_steps=0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for tag, arch in ARCHS.items():
        model = j_build_model(j_get_smoke_config(arch).with_policy(J_POLICIES["native_f32"]))
        params = numpy_params(model, 0)
        inputs.update(flat_numpy(params, f"params_{tag}"))
        step = jax.jit(jstep.make_train_step(model, tcfg))
        jparams = jax.tree.map(jnp.asarray, params)
        state = {"params": jparams, "opt": jadamw.init_state(jparams, tcfg.optimizer)}
        _, m = step(state, jbatch)
        ref[tag] = (float(m["loss"]), float(m["grad_norm"]))
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    return ref, spawn_ranks("moe", WORLD, d)


@pytest.mark.parametrize("tag", ARCHS)
def test_sharded_step_within_the_bound_of_the_unsharded_step(run, tag):
    """Each of two sharded steps against the unsharded step from the same
    state (the second from the sharded run's state after the first)."""
    _, outs = run
    for out in outs:
        rec = out[tag]
        for sharded, plain in zip(rec["sharded_losses"], rec["unsharded_losses"], strict=True):
            assert abs(sharded - plain) < SHARDED_LOSS_TOL, rec
        for sharded, plain in zip(rec["sharded_grad_norms"], rec["unsharded_grad_norms"],
                                  strict=True):
            assert abs(sharded - plain) <= GRAD_TOL_MOE * plain, rec
        assert rec["grad_gap"] <= GRAD_TOL_MOE


def test_microbatches_of_one_row_within_the_bound_of_the_unsharded_step(run):
    """Phi-3.5-MoE with ``accum_steps=8``: eight microbatches of one row,
    each replicated over 'data' (a row does not split over two ranks), the
    experts still over 'model'."""
    _, outs = run
    for out in outs:
        (loss, sloss), (gn, sgn) = out["phi"]["accum8"]["loss"], out["phi"]["accum8"]["grad_norm"]
        assert abs(sloss - loss) < SHARDED_LOSS_TOL
        assert abs(sgn - gn) <= GRAD_TOL_MOE * gn


@pytest.mark.parametrize("tag", ARCHS)
def test_sharded_step_matches_the_references_single_device_step(run, tag):
    """The sharded step's loss and gradient norm at the shared first state
    against the reference's jitted step (the second step starts from
    states that AdamW's first update has parted: see above)."""
    ref, outs = run
    (want, want_gnorm) = ref[tag]
    for out in outs:
        got = out[tag]["sharded_losses"][0]
        assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
        gnorm = out[tag]["sharded_grad_norms"][0]
        assert abs(gnorm - want_gnorm) <= GRAD_TOL_MOE * want_gnorm, (gnorm, want_gnorm)
    assert all(o[tag]["sharded_losses"] == outs[0][tag]["sharded_losses"] for o in outs)


@pytest.mark.parametrize("shape", ["train", "decode"])
@pytest.mark.parametrize("tag", ARCHS)
def test_the_layer_on_the_same_inputs_is_the_unsharded_layer(run, tag, shape):
    """(4, 64, D) tokens in groups of 64, and (4, 1, D): one decode group of
    the four rows across the two 'data' ranks, at the whole batch's
    capacity."""
    _, outs = run
    for out in outs:
        rec = out[tag][f"layer_{shape}"]
        assert rec["out_equal"] and rec["x_grad_equal"] and rec["routing_equal"], rec
        assert rec["capacity"] == ([40, 40] if shape == "train" else [2, 2])
        assert rec["w_grad_gap"] <= GRAD_TOL, rec
        assert rec["aux"][1] == pytest.approx(rec["aux"][0], rel=1e-6)
        # the weights' gradients in the weights' layout: E over 'model'
        assert rec["grad_placements"] == out[tag]["layer_placements"] == [
            "(Shard(dim=1), Shard(dim=0))", "(Shard(dim=2), Shard(dim=0))"]


@pytest.mark.parametrize("tag", ARCHS)
def test_expert_leaves_keep_their_experts_on_model(run, tag):
    """After two steps the stacked (L, E, D, F) / (L, E, F, D) expert
    weights and their gradients hold E over 'model' and D over 'data':
    two of the four experts a rank."""
    _, outs = run
    want = {"gate": "(Shard(dim=2), Shard(dim=1))", "up": "(Shard(dim=2), Shard(dim=1))",
            "down": "(Shard(dim=3), Shard(dim=1))"}
    layers = MOE_LAYERS[tag]
    for out in outs:
        rec = out[tag]
        assert rec["expert_placements"] == want
        assert rec["expert_grad_placements"] == want
        assert rec["expert_local_shapes"] == {"gate": [layers, 2, 64, 256],
                                              "up": [layers, 2, 64, 256],
                                              "down": [layers, 2, 256, 64]}


@pytest.mark.parametrize("tag", ARCHS)
def test_replicas_are_bit_identical_across_ranks(run, tag):
    """After two steps, every leaf of the state holds the same bytes on
    every rank that holds the same shard of it."""
    _, outs = run
    paths = outs[0][tag]["replicas"].keys()
    assert len(paths) > 20
    groups = 0
    for path in paths:
        seen: dict = {}
        for out in outs:
            rec = out[tag]["replicas"][path]
            seen.setdefault(rec["key"], set()).add(rec["hash"])
        assert all(len(h) == 1 for h in seen.values()), (path, seen)
        groups += len(seen)
    assert groups < len(paths) * WORLD


@pytest.mark.parametrize("tag", ARCHS)
def test_cached_decode_routes_the_batch_as_one_group(run, tag):
    """A prefill of 8 tokens and four decode steps of four rows each: every
    step's routing equals the unsharded one, and one group of the four
    rows keeps more assignments than a group of each rank's own rows
    would."""
    _, outs = run
    steps = MOE_LAYERS[tag] * 4
    for out in outs:
        rec = out[tag]["decode"]
        assert rec["gap"] <= DECODE_TOL, rec
        assert rec["steps"] == 5
        assert rec["routing_calls"] == [steps, steps] and rec["routing_equal"], rec
        assert rec["kept_one_group"] > rec["kept_per_rank_groups"], rec
