"""The reference's per-architecture smoke cells (``tests/test_archs_smoke.py``)
on the port, for all ten architectures: reduced configs (same family and
topology), a forward pass on the CPU with shapes and finiteness asserted,
the full configs against the assignment, and the per-family details (QKV
bias, expert counts, Kimi-K2's dense first layer and shared expert, the
RecurrentGemma pattern, an attention-free Mamba-2, a live precision policy).
Beside them, each architecture's forward against the reference's on the
same numpy-made weights.

The reference's ``test_train_step_reduces_loss_shape`` cell runs on the
port's training step (``repro_torch.train``) for every architecture; the
port's gradients against the reference's are in ``test_torch_train``.

Tolerance of the forward against the reference: the policy's ceiling
(``MODE_REL_ERROR``) times ``FACTOR`` per four layers, plus, for the MoE
family, one bf16 quantum: the layer rounds its expert inputs and outputs to
bf16, where values an ulp apart may round to neighbouring codes
(``test_torch_moe``)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import NATIVE_F32, PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.plan import MODE_REL_ERROR
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

from test_torch_common import CACHE_QUANTUM, FACTOR, _gap, make_pair

B, S = 2, 32


def _batch(cfg, rng, to=torch.from_numpy):
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": to(toks)}
    if cfg.family == "encdec":
        batch["frames"] = to((rng.standard_normal((B, 16, cfg.d_model)) * 0.02
                              ).astype(np.float32))
    if cfg.family == "vlm":
        batch["pixel_embeds"] = to((rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    return batch


def _model(cfg):
    model = build_model(cfg, device="cpu")
    return model, model.init(0)


@pytest.mark.parametrize("arch", ARCH_IDS)
class TestArchSmoke:
    def test_forward_shapes_finite(self, arch, rng):
        cfg = get_smoke_config(arch).with_policy(NATIVE_F32)
        model, params = _model(cfg)
        logits, aux = model.apply(params, _batch(cfg, rng))
        assert logits.shape == (B, S, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        assert bool(torch.isfinite(aux))
        assert (float(aux) > 0) == (cfg.family == "moe")

    def test_train_step_reduces_loss_shape(self, arch, rng):
        cfg = get_smoke_config(arch).with_policy(NATIVE_F32)
        model = build_model(cfg, device="cpu")
        tcfg = TrainConfig(
            optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10),
            accum_steps=2,
        )
        step = make_train_step(model, tcfg)
        state = init_train_state(model, 1, tcfg)
        batch = _batch(cfg, rng)
        batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
        state, m1 = step(state, batch)
        state, m2 = step(state, batch)  # same batch twice: loss must drop
        assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
        assert float(m2["loss"]) < float(m1["loss"])
        assert float(m1["grad_norm"]) > 0

    def test_full_config_matches_assignment(self, arch):
        cfg = get_config(arch)
        spec = {
            "qwen1.5-4b": (40, 2560, 20, 20, 6912, 151936),
            "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000),
            "phi3-mini-3.8b": (32, 3072, 32, 32, 8192, 32064),
            "qwen1.5-0.5b": (24, 1024, 16, 16, 2816, 151936),
            "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
            "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064),
            "kimi-k2-1t-a32b": (61, 7168, 64, 8, 2048, 163840),
            "whisper-medium": (24, 1024, 16, 16, 4096, 51865),
            "mamba2-2.7b": (64, 2560, 0, 0, 0, 50280),
            "recurrentgemma-9b": (38, 4096, 16, 1, 12288, 256000),
        }[arch]
        got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab)
        assert got == spec, f"{arch}: {got} != {spec}"

    def test_forward_vs_reference(self, arch):
        jmodel, jparams, tmodel, tparams = make_pair("native_f32", arch=arch)
        cfg = tmodel.cfg
        jl, jaux = jax.jit(jmodel.apply)(jparams, _batch(cfg, np.random.default_rng(0),
                                                         jnp.asarray))
        tl, taux = tmodel.apply(tparams, _batch(cfg, np.random.default_rng(0)))
        depth = cfg.n_layers + cfg.n_encoder_layers
        tol = MODE_REL_ERROR[Mode.M24] * FACTOR * max(1.0, depth / 4)
        if cfg.family == "moe":
            tol += CACHE_QUANTUM["bfloat16"]
        assert _gap(tl.numpy(), jl) <= tol
        assert abs(float(taux) - float(jaux)) <= tol * max(1.0, abs(float(jaux)))

    def test_decode_step_from_a_fresh_state(self, arch):
        """A 4-token prefill and one step on the per-slot serving state (an
        enc-dec state after ``prefill_encoder``, a VLM prefill with its
        patches): finite logits of the text rows, positions advanced."""
        cfg = get_smoke_config(arch).with_policy(NATIVE_F32)
        model, params = _model(cfg)
        batch = _batch(cfg, np.random.default_rng(1))
        state = model.init_decode_state(B, 64, per_slot=True)
        if cfg.family == "encdec":
            state = model.prefill_encoder(params, batch["frames"], state)
        pix = batch.get("pixel_embeds")
        logits, state = model.decode_step(params, batch["tokens"][:, :4], state,
                                          pixel_embeds=pix)
        assert logits.shape == (B, 4, cfg.vocab)
        logits, state = model.decode_step(params, batch["tokens"][:, 4:5], state)
        assert logits.shape == (B, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
        n_pix = 0 if pix is None else pix.shape[1]
        assert state.position.tolist() == [5 + n_pix] * B


class TestArchDetails:
    def test_qwen_has_qkv_bias(self):
        _, params = _model(get_smoke_config("qwen1.5-4b"))
        assert "b" in params["layers"]["seg0_dense"]["attn"]["wq"]

    def test_command_r_no_bias(self):
        _, params = _model(get_smoke_config("command-r-plus-104b"))
        assert "b" not in params["layers"]["seg0_dense"]["attn"]["wq"]

    def test_moe_expert_counts(self):
        cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
        _, params = _model(cfg)
        moe = params["layers"]["seg0_moe"]["moe"]
        assert moe["gate"].shape[1] == cfg.moe_experts  # (L, E, D, F)
        assert tuple(moe["down"].shape) == (cfg.n_layers, cfg.moe_experts, cfg.d_ff,
                                            cfg.d_model)

    def test_kimi_first_layer_dense_plus_shared_expert(self):
        cfg = get_smoke_config("kimi-k2-1t-a32b")
        model, params = _model(cfg)
        assert model.segments[0] == ("dense", 1)
        assert "shared" in params["layers"]["seg1_moe"]["moe"]
        state = model.init_decode_state(2, 8, per_slot=True)
        assert list(state.caches) == ["seg0_dense", "seg1_moe"]
        assert [len(v) for v in state.caches.values()] == [1, cfg.n_layers - 1]

    def test_whisper_has_an_encoder_and_cross_attention(self):
        cfg = get_smoke_config("whisper-medium")
        model, params = _model(cfg)
        assert model.kinds == ["dec"] * cfg.n_layers
        assert params["enc_layers"]["attn"]["wq"]["w"].shape[0] == cfg.n_encoder_layers
        dec = params["layers"]["seg0_dec"]
        assert {"cross", "norm3"} <= set(dec) and "b" in dec["mlp"]["up"]

    def test_recurrentgemma_pattern(self):
        cfg = get_config("recurrentgemma-9b")
        model = build_model(cfg, device="cpu")  # no init: the full size
        kinds = [k for k, n in model.segments for _ in range(n)]
        assert kinds[:6] == ["rec", "rec", "attn_local", "rec", "rec", "attn_local"]
        assert len(kinds) == 38 and kinds[-2:] == ["rec", "rec"]

    def test_mamba2_is_attention_free(self):
        _, params = _model(get_smoke_config("mamba2-2.7b"))
        flat = jax.tree_util.tree_leaves_with_path(params)
        assert not any("attn" in jax.tree_util.keystr(p) for p, _ in flat)

    def test_rmpm_policy_changes_results(self, rng):
        # the engine is live in the models: policy M8 vs M24 must differ
        cfg = get_smoke_config("qwen1.5-0.5b")
        model8, params = _model(cfg.with_policy(PrecisionPolicy(default=Mode.M8)))
        model24 = build_model(cfg.with_policy(PrecisionPolicy(default=Mode.M24)), device="cpu")
        batch = _batch(cfg, rng)
        l8, _ = model8.apply(params, batch)
        l24, _ = model24.apply(params, batch)
        diff = float((l8 - l24).abs().max())
        assert 0 < diff < 1.0  # different rounding, same model

    def test_every_family_builds(self):
        families = {get_config(a).family for a in ARCH_IDS}
        assert families == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
        for arch in ARCH_IDS:
            assert build_model(get_smoke_config(arch), device="cpu").layers
