"""Port vs reference, the two families the launchers do not serve, at the
model's own entry points (as the reference drives them): ``whisper-medium``
(enc-dec: a non-causal encoder over frame embeddings, decoder blocks with
cross-attention and a GELU MLP) and ``internvl2-1b`` (VLM: patch embeddings
prepended to the text), at their smoke sizes (2 encoder + 4 decoder layers;
4 layers and 16 patches; d_model 128, vocab 512).  Inputs are drawn by
numpy from a seed and handed to both packages.

* ``apply`` logits against the reference's, under three policies;
* ``prefill_encoder`` + ``decode_step`` (a prefill, then teacher-forced
  single-token steps) and ``decode_step(pixel_embeds=)`` against the
  reference's;
* within the port, ``apply`` against a prefill and a decode loop.

Tolerance: the policy's ceiling (``MODE_REL_ERROR``) times ``FACTOR`` per
four layers the error passes through (the encoder's layers count too), and
for steps that read a bf16 KV cache the port filled itself a share
``CACHE_FLIP_SHARE`` of one cache quantum on top (``test_torch_model``)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.models import layers as jlayers

from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as tlayers
from repro_torch.plan import MODE_REL_ERROR

from test_torch_common import (
    CACHE_FLIP_SHARE,
    CACHE_QUANTUM,
    FACTOR,
    POLICY_CASES,
    _gap,
    make_pair,
)

WHISPER = "whisper-medium"
VLM = "internvl2-1b"
ARCHS = [WHISPER, VLM]
B, S, ENC = 2, 12, 10


def _tol(policy_name, cfg, decode):
    depth = cfg.n_layers + cfg.n_encoder_layers
    tol = MODE_REL_ERROR[POLICY_CASES[policy_name][2]] * FACTOR * max(1.0, depth / 4)
    if decode:
        tol += CACHE_QUANTUM[cfg.kv_cache_dtype] * CACHE_FLIP_SHARE
    return tol


def _inputs(cfg, seed=0):
    """tokens, and the family's extra input (frames or patch embeddings),
    as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "encdec":
        extra = (rng.standard_normal((B, ENC, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        extra = (rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model)) * 0.02
                 ).astype(np.float32)
    return toks, extra


def _batch(cfg, toks, extra, to):
    key = "frames" if cfg.family == "encdec" else "pixel_embeds"
    return {"tokens": to(toks), key: to(extra)}


@pytest.mark.parametrize("policy_name", list(POLICY_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_vs_reference(arch, policy_name):
    jmodel, jparams, tmodel, tparams = make_pair(policy_name, arch=arch)
    cfg = tmodel.cfg
    toks, extra = _inputs(cfg)
    jl, jaux = jax.jit(jmodel.apply)(jparams, _batch(cfg, toks, extra, jnp.asarray))
    tl, taux = tmodel.apply(tparams, _batch(cfg, toks, extra, torch.from_numpy))
    assert tl.shape == (B, S, cfg.vocab) == jl.shape  # VLM: the patch rows are dropped
    assert bool(torch.isfinite(tl).all())
    assert _gap(tl.numpy(), jl) <= _tol(policy_name, cfg, False)
    assert float(taux) == float(jaux) == 0.0


def _states(jmodel, tmodel, cfg, extra, jparams, tparams):
    """Fresh per-slot decode states of both packages; enc-dec: with the
    encoder's output (``prefill_encoder``)."""
    js = jmodel.init_decode_state(B, 64, per_slot=True)
    ts = tmodel.init_decode_state(B, 64, per_slot=True)
    if cfg.family == "encdec":
        js = jmodel.prefill_encoder(jparams, jnp.asarray(extra), js)
        ts = tmodel.prefill_encoder(tparams, torch.from_numpy(extra), ts)
    return js, ts


@pytest.mark.parametrize("policy_name", list(POLICY_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_vs_reference(arch, policy_name):
    """A 6-token prefill (enc-dec: after the encoder; VLM: with the patch
    embeddings prepended) and six teacher-forced steps."""
    jmodel, jparams, tmodel, tparams = make_pair(policy_name, arch=arch)
    cfg = tmodel.cfg
    toks, extra = _inputs(cfg, seed=1)
    js, ts = _states(jmodel, tmodel, cfg, extra, jparams, tparams)
    if cfg.family == "encdec":
        assert _gap(ts.enc_out.numpy(), js.enc_out) <= _tol(policy_name, cfg, False)
        jl, js = jmodel.decode_step(jparams, jnp.asarray(toks[:, :6]), js)
        tl, ts = tmodel.decode_step(tparams, torch.from_numpy(toks[:, :6]), ts)
    else:
        jl, js = jmodel.decode_step(jparams, jnp.asarray(toks[:, :6]), js,
                                    pixel_embeds=jnp.asarray(extra))
        tl, ts = tmodel.decode_step(tparams, torch.from_numpy(toks[:, :6]), ts,
                                    pixel_embeds=torch.from_numpy(extra))
    assert tl.shape == (B, 6, cfg.vocab)
    assert _gap(tl.numpy(), jl) <= _tol(policy_name, cfg, False)
    assert np.array_equal(ts.position.numpy(), np.asarray(js.position))
    for i in range(6, S):
        jl, js = jmodel.decode_step(jparams, jnp.asarray(toks[:, i:i + 1]), js)
        tl, ts = tmodel.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]), ts)
        assert _gap(tl.numpy(), jl) <= _tol(policy_name, cfg, True), i
    assert np.array_equal(ts.position.numpy(), np.asarray(js.position))
    if cfg.family == "vlm":
        assert ts.position.tolist() == [cfg.n_vision_tokens + S] * B


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_equals_prefill_then_decode_within_the_port(arch):
    """``apply`` over the sequence against a 4-token prefill and single-token
    steps of the same sequence (the steps read the bf16 cache)."""
    _, _, tmodel, tparams = make_pair("native_f32", arch=arch)
    cfg = tmodel.cfg
    toks, extra = _inputs(cfg, seed=2)
    full, _ = tmodel.apply(tparams, _batch(cfg, toks, extra, torch.from_numpy))
    state = tmodel.init_decode_state(B, 64, per_slot=True)
    pix = None
    if cfg.family == "encdec":
        state = tmodel.prefill_encoder(tparams, torch.from_numpy(extra), state)
    else:
        pix = torch.from_numpy(extra)
    outs = []
    logits, state = tmodel.decode_step(tparams, torch.from_numpy(toks[:, :4]), state,
                                       pixel_embeds=pix)
    outs.append(logits)
    for i in range(4, S):
        logits, state = tmodel.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]), state)
        outs.append(logits)
    assert _gap(torch.cat(outs, 1).numpy(), full.numpy()) <= CACHE_QUANTUM["bfloat16"]


def test_cross_attention_reads_the_encoder_without_cache_or_rope():
    """``attention_apply(kv_override=)``: K and V projected from the encoder
    output, no cache touched, no causal mask — against the reference's."""
    jmodel, jparams, tmodel, tparams = make_pair("native_f32", arch=WHISPER)
    cfg = tmodel.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["seg0_dec"]["cross"])
    tp = jax.tree.map(lambda a: a[0], tparams["layers"]["seg0_dec"]["cross"])
    jout, jc = jlayers.attention_apply(jp, jnp.asarray(x), jmodel.cfg,
                                       kv_override=(jnp.asarray(enc), jnp.asarray(enc)))
    tout, tc = tlayers.attention_apply(tp, torch.from_numpy(x), cfg,
                                       kv_override=(torch.from_numpy(enc),) * 2)
    assert jc is None and tc is None
    assert _gap(tout.numpy(), jout) <= _tol("native_f32", cfg, False)
    # not causal: the first query sees every encoder position, so moving the
    # last one changes it
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    tout2, _ = tlayers.attention_apply(tp, torch.from_numpy(x), cfg,
                                       kv_override=(torch.from_numpy(enc2),) * 2)
    assert not torch.allclose(tout2[:, 0], tout[:, 0])


def test_gelu_mlp_vs_reference():
    _, jparams, tmodel, tparams = make_pair("native_f32", arch=WHISPER)
    jp = jax.tree.map(lambda a: a[0], jparams["enc_layers"]["mlp"])
    tp = jax.tree.map(lambda a: a[0], tparams["enc_layers"]["mlp"])
    x = np.random.default_rng(5).standard_normal((B, 5, tmodel.cfg.d_model)).astype(np.float32)
    want = jlayers.gelu_mlp_apply(jp, jnp.asarray(x), POLICY_CASES["native_f32"][1])
    got = tlayers.gelu_mlp_apply(tp, torch.from_numpy(x), tmodel.cfg.policy)
    assert _gap(got.numpy(), want) <= MODE_REL_ERROR[POLICY_CASES["native_f32"][2]] * FACTOR


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_the_family_with_the_references_message(arch):
    with pytest.raises(SystemExit, match="use examples/ for multimodal drivers on CPU"):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_encdec_state_carries_the_encoder_output_through_steps():
    """``decode_step`` keeps ``enc_out`` (the same tensor) and a state
    without it cannot run the decoder's cross-attention."""
    _, _, tmodel, tparams = make_pair("native_f32", arch=WHISPER)
    cfg = tmodel.cfg
    toks, extra = _inputs(cfg)
    state = tmodel.prefill_encoder(tparams, torch.from_numpy(extra),
                                   tmodel.init_decode_state(B, 32, per_slot=True))
    enc = state.enc_out
    assert tuple(enc.shape) == (B, ENC, cfg.d_model)
    _, state = tmodel.decode_step(tparams, torch.from_numpy(toks[:, :3]), state)
    assert state.enc_out is enc
    empty = dataclasses.replace(state, enc_out=None)
    with pytest.raises((TypeError, AttributeError)):
        tmodel.decode_step(tparams, torch.from_numpy(toks[:, 3:4]), empty)
