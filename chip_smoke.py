#!/usr/bin/env python3
"""chip_smoke.py — drive the PyTorch/CUDA port end to end on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the five CUDA kernels from ``src/repro_torch/csrc`` (once), holds
each against its plain PyTorch version on the card at the shapes its path
gives it (the decode-attention kernel at both benchmark cells' shapes, with
planted faults refused, with bound device-scalar modes, and through
``flash_attention``'s route; the limb, mode-map and double-f32 kernels at the K split
``split_k`` plans, which it prints per shape, and unsplit; the limb and
mode-map kernels through their weight-streaming body at M <= 16 — also on
misaligned operands and captured in a CUDA graph — and their tensor-core
tile body above, at M in ``MMA_ROWS`` over every held (K, N), ragged, on
misaligned operands and under 16 x 16 map tiles), times them beside their
bound (each row names its ``path`` and ``share_of_bound``; ptxas's
registers, spills and shared memory of every weight-streaming and
tensor-core tile instantiation go into the ``kernels`` line), then
serves ``qwen1.5-0.5b`` at
full width (seed-made weights) through ``repro_torch.serve.ServeEngine`` in
four configurations, runs the autotuner on the card and plans from its
table, serves self-speculatively beside a plain arm, and serves from the
paged KV cache (prefix sharing, page-pressure parking, precision-tiered
pages through the quantize kernel) beside the dense cache, and serves two
tenants with mode tables of their own (per-tenant adaptation through the
mode-map kernel), the conditioned hot/cold workload and a traced run
(Chrome trace, profiler), then the recurrent families: ``mamba2-2.7b`` at
full width and depth (``serve_ssm``) and ``recurrentgemma-9b`` at full
width and depth, with its speculative, paged and ring-wrap arms at cut
depths (``serve_hybrid``), then the remaining families: Phi-3.5-MoE at full
width cut to 8 layers, plain, modal, speculative and paged
(``serve_moe``), the dense configs qwen1.5-4b and phi3-mini at full depth
and command-r+ at one layer (``serve_configs``), and Whisper (enc-dec) and
InternVL2 (VLM) through the model's own entry points (``multimodal``),
checking what comes out, and last trains ``qwen1.5-0.5b`` at full width and
depth through ``repro_torch.train`` (``train``: native f32, M24 through the
plain limb algebra, the grad-drift precision schedule, gradient
accumulation, a checkpoint restored on the card; a train step through the
kernels must raise, as the reference's ``jax.grad`` through a Pallas kernel
does, and no kernel launches while training), then trains it over a
one-rank NCCL ``DeviceMesh`` (``distributed``: the (1, 1) mesh step against
the unsharded one and its cost, int8 gradient compression over a (1, 1, 1)
mesh, the S = 1 pipeline, a checkpoint restored onto the mesh), then
counts steps with the op recorder (``cost``: the train step on real and
fake tensors against its measured time, the decode step on the card and
on the CPU, the analysis gate on the card, two production dry-run cells
on this machine's CPU), and last runs the five port arms of ``examples/``
through their ``main()`` at the reference scripts' sizes (``examples``: one
captured graph of the mode-map kernel replayed at three modes, each replay
bit-equal to the limb kernel; streamed == batch tokens; a preempted and
resumed training run against the uninterrupted one).  The limb
and mode-map kernels are also held and timed at those models' GEMM shapes.  The engine runs its
decode step, probe and speculative round as CUDA graphs
(``repro_torch.serve.graphs``); ``serve_static``, ``serve_adapt``,
``serve_spec`` and ``serve_tenants`` also serve eagerly (``graphs.eager()``)
and require the same tokens, and ``step_breakdown`` times a decode step both
ways.  Every phase
prints one JSON line; any failed phase ends the run with a non-zero exit
code.  There is no CPU mode: without a GPU the script raises before it
prints any result.

``--phases a,b`` runs a subset (for a first build check); ``--layers N`` cuts
the depth of the earlier serving phases' model (widths are never cut; the
``tune``, ``serve_spec``, ``serve_paged``, ``serve_tenants``, ``train`` and
``distributed`` phases always run at full depth, and ``serve_ssm``,
``serve_hybrid``, ``serve_moe``, ``serve_configs`` and ``multimodal`` at the
depths their docstrings give).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import math
import os
import itertools
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import weakref
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.adapt import (  # noqa: E402
    SLO,
    DeviceModes,
    ModeTable,
    PageTierPolicy,
    TrainPrecisionSchedule,
    bind_modes,
)
from repro_torch.adapt.workload import conditioned_model  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Mode, PrecisionPolicy  # noqa: E402
from repro_torch.core.precision import F32_MODES  # noqa: E402
from repro_torch.core.policy import PRESETS  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import compress, pipeline  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    decode_state_shardings,
    input_shardings,
    param_shardings,
    put,
)
from repro_torch.core.limb import limb_product_terms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.limb_matmul.ops import (  # noqa: E402
    gemm_body,
    k_step,
    k_walk,
    limb_matmul,
    limb_matmul_dd,
    limb_matmul_dd_plain,
    limb_matmul_plain,
    SKINNY_M_MAX,
    reduce_splits_dd,
    resolve_splits,
    split_pieces,
    split_ranges,
    tile_grid,
)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    attention_f64,
    drop_top_key,
    held_to_plain,
)
from repro_torch.kernels.quantize_mantissa.ops import (  # noqa: E402
    quantize_mantissa_op,
    quantize_mantissa_plain,
)
from repro_torch.kernels.tile_matmul.ops import (  # noqa: E402
    tile_matmul,
    tile_matmul_mode,
    tile_matmul_plain,
    tile_matmul_runtime,
)
from repro_torch import oprecord  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.launch.serve import run_open_loop  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_mesh  # noqa: E402
from repro_torch.launch.train import mode_timeline, put_batch_on  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.lm import (  # noqa: E402
    _block_apply,
    copy_state_,
    map_state,
    state_leaves,
)
from repro_torch.models.moe import capacity_for  # noqa: E402
from repro_torch.obs import TraceConfig, span_violations, validate_chrome  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.plan import F32_FLOPS, HBM_BW, PEAK_FLOPS  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdaptConfig,
    CacheConfig,
    Request,
    RequestClass,
    SchedulingConfig,
    ServeConfig,
    ServeEngine,
    Tenant,
    class_requests,
    ragged_requests,
)
from repro_torch.serve.graphs import eager  # noqa: E402
from repro_torch.serve.paged import batch_leaves, tier_node  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainConfig,
    laid_out,
    like_params,
    make_grad_fn,
    make_loss_fn,
    make_modal_step,
    make_train_step,
    mesh_scope,
    state_mesh,
    state_shardings,
)
from repro_torch.tune import TuneTable, tune  # noqa: E402

ARCH = "qwen1.5-0.5b"
#: (K, N) of the weight GEMMs on the serving path: wq/wk/wv/wo, gate/up, down
MAIN_KN = ((1024, 1024), (1024, 2816), (2816, 1024))
#: M of the decode step (slots) and of a prefill (longest prompt)
MAIN_M = (4, 48)
#: M > 16 rows the tensor-core tile body is held at over every held (K, N):
#: the first row past the skinny body, Whisper's ``apply`` decoder, a
#: prefill, one past a 64-row block, InternVL2's patch rows, Whisper's frames
MMA_ROWS = (17, 23, 48, 65, 264, 1500)
#: matmul kernels vs their plain versions: max-abs error over result scale
#: (the bound the reference holds its own kernels to)
MATMUL_TOL = 2e-6
#: double-f32 kernel, over the result's scale: (hi + lo) against an f64
#: product (the reference's bound for its own kernel), |lo| against max|hi|,
#: and (hi + lo) against the plain version at the same K split folding at the
#: kernel's K step — each of the two is held within 2^-22 of f64, so they may
#: differ by twice that (their products are summed in other orders inside a
#: K step)
DD_F64_TOL = 2.0**-22
DD_LO_RATIO = 2.0**-20
DD_TOL = 2.0**-21
#: split against unsplit, over the result's scale: both fold the same K
#: steps' partials, so they differ only by the pair's own rounding — at most
#: about T * terms * 2^-48 of a running sum (6.6e-12 at 48x2816x1024, k = 6);
#: a reduction that loses lo_s or TwoSum's error moves the result by about
#: 2^-24 of a partial, far above this limit
DD_SPLIT_TOL = 2.0**-32
#: (M, K, N, limbs) checked and timed: the reference's test shape, a ragged
#: shape, and the serving shapes at M32 (4 limbs) and M48 (6 limbs)
DD_CASES = ((64, 128, 64, 3), (17, 33, 9, 3), (17, 33, 9, 4), (17, 33, 9, 6)) + tuple(
    (m, k, n, limbs) for limbs in (4, 6) for m in MAIN_M for (k, n) in MAIN_KN)
#: one K or V pool of ``serve_paged``'s 512-token, 8-slot cache: 256 pages
#: of 16 tokens + the scratch page, 16 KV heads of 64
PAGED_POOL_SHAPE = (257, 16, 16, 64)
PHASES = ("device", "kernels", "serve_static", "serve_adapt", "serve_grte",
          "serve_planned", "tune", "serve_spec", "serve_paged", "serve_tenants",
          "serve_ssm", "serve_hybrid", "serve_moe", "serve_configs", "multimodal", "train",
          "distributed", "cost", "examples")
#: the recurrent families' models (full width; see their phases for depth)
SSM_ARCH = "mamba2-2.7b"
HYBRID_ARCH = "recurrentgemma-9b"
#: (K, N) of the hybrid's weight GEMMs through pmm (M = 4 decode, 48
#: prefill): wq / wo, wk / wv (MQA: one KV head of 256), the MLP's gate / up,
#: its down
HYBRID_KN = ((4096, 4096), (4096, 256), (4096, 12288), (12288, 4096))
#: the multimodal phase: Whisper's encoder frames (30 s of audio),
#: InternVL2's patch embeddings per image (its config's n_vision_tokens), the
#: prompt and the greedy tokens after it
WHISPER_ARCH, VLM_ARCH = "whisper-medium", "internvl2-1b"
WHISPER_FRAMES, VLM_PATCHES = 1500, 256
MM_PROMPT, MM_NEW = 8, 16
#: ``apply``'s decoder rows in the multimodal check: the prompt and the
#: tokens fed back
MM_APPLY = MM_PROMPT + MM_NEW - 1
#: family -> (the M its phase gives the weight GEMMs through pmm, their (K,
#: N)), beside the hybrid's: Phi-3.5-MoE's attention (its experts are general
#: einsums), the dense MLPs and attention of qwen1.5-4b, phi3-mini and
#: command-r+ (M = 4 decode, 48 prefill); Whisper's attention and GELU MLP
#: (M = 1 decode, the prompt, ``apply``'s decoder, the encoder's frames, which
#: every call's cross-attention K / V projects too) and InternVL2's attention
#: (14 query heads, 2 KV heads of 64) and SwiGLU MLP (M = 1 decode, the
#: patches and the prompt, the same in ``apply``)
FAMILY_SHAPES = {
    "recurrentgemma-9b": (MAIN_M, HYBRID_KN),
    "phi3.5-moe-42b-a6.6b": (MAIN_M, ((4096, 4096), (4096, 1024))),
    "qwen1.5-4b": (MAIN_M, ((2560, 2560), (2560, 6912), (6912, 2560))),
    "phi3-mini-3.8b": (MAIN_M, ((3072, 3072), (3072, 8192), (8192, 3072))),
    "command-r-plus-104b": (MAIN_M, ((12288, 12288), (12288, 1024), (12288, 33792),
                                     (33792, 12288))),
    WHISPER_ARCH: ((1, MM_PROMPT, MM_APPLY, WHISPER_FRAMES),
                   ((1024, 1024), (1024, 4096), (4096, 1024))),
    VLM_ARCH: ((1, VLM_PATCHES + MM_PROMPT, VLM_PATCHES + MM_APPLY),
               ((896, 896), (896, 128), (896, 4864), (4864, 896))),
}
#: the MoE phase's model and its depth cut: 8 of Phi-3.5-MoE's 32 layers
#: (5.03 GB of f32 experts and 0.17 GB of attention a layer: ~42.7 GB with the
#: embeddings; all 32 layers would be ~167 GB, more than the card holds)
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_CUT_LAYERS = 8
#: the dense configs served in serve_configs (arch -> depth; None = full):
#: command-r+ at one of its 64 layers (its two 256000 x 12288 embeddings are
#: 25.2 GB, the logits' M16 limbs another 25.2 GB, a layer 6.3 GB)
CONFIG_DEPTHS = {"qwen1.5-4b": None, "phi3-mini-3.8b": None, "command-r-plus-104b": 1}
#: depth cuts of the hybrid phase's arms: the speculative and paged arms run
#: two (rec, rec, attn_local) supergroups and the two remainder layers; the
#: ring-wrap part one supergroup, over a shared prompt prefix of
#: HYBRID_WRAP_PREFIX tokens that decoding carries across the 2048 window
HYBRID_CUT_LAYERS = 8
HYBRID_WRAP_LAYERS = 3
HYBRID_WRAP_PREFIX = 2032
#: the train phase: the reference launcher's defaults (``repro.launch.train``)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 1e-3
#: accum_steps=2 against 1 on one batch (train arm d): the gradients within
#: ACCUM_GRAD_TOL of each leaf's largest magnitude (f32 sums in other
#: orders); the two steps' updates within ACCUM_UPDATE_TOL of the update's
#: norm (AdamW's first step is g / (|g| + eps): an element whose gradient is
#: near eps, where the last bits of the sums are, may move by a large share
#: of the learning rate, so no element-wise bound holds); the loss after the
#: step and the grad norms within ACCUM_LOSS_TOL, relative
ACCUM_GRAD_TOL = 2.0**-14
ACCUM_UPDATE_TOL = 2.0**-8
ACCUM_LOSS_TOL = 1e-5
#: where the train phase writes its checkpoint (git-ignored; removed after)
TRAIN_CKPT_DIR = os.path.join(_ROOT, "build", "train_ckpt")
#: the distributed phase: its checkpoint (git-ignored; removed after), the
#: relative distance a sharded step may keep from the unsharded one when not
#: bit for bit (GRAD_TOL_NATIVE of tests/test_torch_train.py), the pairs of
#: (unsharded, sharded) steps timed, and the pipeline's microbatches at S = 1
DIST_CKPT_DIR = os.path.join(_ROOT, "build", "dist_ckpt")
DIST_TOL = 2.0**-14
DIST_TIMED_PAIRS = 3
PIPE_MICROBATCHES = 4
#: the distributed phase's MoE arm: 1 of Phi-3.5-MoE's 32 layers at full
#: width (6.2 GB of f32 weights, of them 5.0 GB of experts) with int8 AdamW
#: moments; a step holds two states, the gradients and AdamW's temporaries
#: of each (1, 16, 4096, 6400) expert leaf.  At 2 layers the step ran out of
#: the card's 79.18 GiB (72.0-74.2 GiB allocated on an H100 80GB HBM3).
#: A prefill of MOE_MESH_PROMPT tokens and MOE_MESH_DECODE cached steps of
#: MOE_MESH_ROWS rows
MOE_MESH_LAYERS = 1
MOE_MESH_ROWS, MOE_MESH_PROMPT, MOE_MESH_DECODE = 4, 16, 3
#: where the tune phase writes its measured table (git-ignored)
TUNE_TABLE_PATH = os.path.join(_ROOT, "build", "tuning", "gpu.json")
#: the examples phase: the port arms ``examples/<name>_torch.py``, each run
#: through its ``main()`` at the reference script's sizes, seeds and steps
EXAMPLES = ("quickstart", "strassen_demo", "serve_batched", "train_lm",
            "autoprecision_train")
#: train_lm's preempted run stops after this step; its resume runs the next
TRAIN_LM_CUT = 150
#: where the examples phase writes the arms' checkpoints (git-ignored;
#: removed after) and, without ``--out``, their printed text
EXAMPLES_DIR = os.path.join(_ROOT, "build", "examples")

KERNEL_INFO = {
    "quantize_mantissa": dict(
        route="cuda", source="src/repro_torch/csrc/quantize_mantissa.cu",
        replaces="src/repro/kernels/quantize_mantissa/quantize_mantissa.py:56"),
    "limb_matmul": dict(
        route="cuda", source="src/repro_torch/csrc/limb_matmul.cu",
        replaces="src/repro/kernels/limb_matmul/limb_matmul.py:165"),
    "tile_matmul": dict(
        route="cuda", source="src/repro_torch/csrc/tile_matmul.cu",
        replaces="src/repro/kernels/tile_matmul/tile_matmul.py:82"),
    "limb_matmul_dd": dict(
        route="cuda", source="src/repro_torch/csrc/limb_matmul_dd.cu",
        replaces="src/repro/kernels/limb_matmul/limb_matmul.py:123"),
    "decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces=None, why="the reference's attention is limb algebra (no TPU kernel); the "
                           "port's chunk loop of limb einsums took most of the decode step"),
}
#: the decode-attention kernel at the benchmark cells' shapes: (cell, slots,
#: cache rows, KV heads, query heads a KV head, head dim)
DECODE_ATTN_SHAPES = (("phi3mini-decode-m16", 16, 2048, 32, 1, 96),
                      ("phi35moe-decode-m16", 16, 1024, 8, 4, 128))
#: kernels no serving path calls (as in the reference): their path is their
#: own public entry point, driven in the kernels phase
ENTRY_POINT_KERNELS = {"limb_matmul_dd": "repro_torch.kernels.limb_matmul.limb_matmul_dd"}


#: file that also receives every JSON line (``--out``); the terminal of a
#: remote run may keep only the end of the output
_OUT_PATH: str | None = None


def say(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _OUT_PATH:
        with open(_OUT_PATH, "a") as fh:
            fh.write(line + "\n")


def emit(phase: str, **payload) -> None:
    say({"phase": phase, **payload})


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


_HEAD_START: dict = {}


def _head_start() -> None:
    """Keep the card busy for a few milliseconds (one 4096^3 f32 product), so
    that the launches timed after it are all queued before the first of them
    starts: the events then bracket device time, not the host's launch rate."""
    if not _HEAD_START:
        x = torch.randn((4096, 4096), device="cuda")
        _HEAD_START.update(x=x, out=torch.empty_like(x))
    torch.matmul(_HEAD_START["x"], _HEAD_START["x"], out=_HEAD_START["out"])


def time_ms(fn, n_variants: int = 1, warmup: int = 3, reps: int = 10,
            samples: int = 5) -> tuple[float, float]:
    """``(device_ms, enqueue_ms)`` of one ``fn(i)`` call.  ``device_ms``: CUDA
    events around ``reps`` calls queued behind a head start (see above), median
    over ``samples`` such runs.  ``enqueue_ms``: the host's time to enqueue one
    call (wrapper, checks, allocation, launch), which is what a caller pays
    when the card is faster than the host.  ``fn`` is called with a rotating
    index below ``n_variants`` so a caller can cycle operand copies larger
    than the L2 cache, as the serving path (2.5 GB of weights per step) finds
    them: cold.  A plain version made of many small operations cannot be
    queued ahead of the card; its ``device_ms`` then is its enqueue time."""
    for i in range(warmup):
        fn(i % n_variants)
    torch.cuda.synchronize()
    times, enqueues = [], []
    call = 0
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _head_start()
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(call % n_variants)
            call += 1
        enqueues.append((time.perf_counter() - t0) * 1e3 / reps)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), statistics.median(enqueues)


def wall_ms(fn, reps: int = 5) -> float:
    """Host wall time of one synchronised ``fn()`` call, median of ``reps``
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def n_rotations(nbytes: int) -> int:
    """Copies of an operand needed to exceed the 50 MB L2 between reuses."""
    return max(2, math.ceil(64e6 / max(nbytes, 1)) + 1)


def gemm_bound_ms(m: int, k: int, n: int, passes: float,
                  outputs: int = 1) -> tuple[float, str]:
    """Least time for the GEMM on the data-sheet card: bytes (each operand
    read once, each of the ``outputs`` f32 results written once) over the
    memory rate, or the retained passes' operations over the bf16
    tensor-core rate."""
    flops, nbytes = oprecord.gemm_work(m, k, n, passes, outputs)
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = out.splitlines()[0].strip()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)


def _errs(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max-abs error, the same over the result's scale)."""
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / float(want.abs().max().clamp_min(1e-30))


def _mixed_map(grid, gen_cpu, kmax=3):
    return torch.randint(1, kmax + 1, grid, generator=gen_cpu, dtype=torch.int32).cuda()


def planned_splits(m: int, k: int, n: int, limbs: int = 3, dd: bool = False, **blk) -> int:
    """The K split count the limb and mode-map wrappers (``dd``: the
    double-f32 wrapper, always the tiled body) run at on this card for
    (m, k, n) at the blocks ``blk`` (default: the wrappers')."""
    _, (bm, bn, bk) = tile_grid(m, n, k, **blk)
    return resolve_splits(None, torch.device("cuda", torch.cuda.current_device()), m, n, k,
                          bm=bm, bn=bn, bk=bk, tk=k_step(limbs),
                          body="wide" if dd else gemm_body(m, limbs))


def check_kernels(gen) -> dict:
    """Hold every kernel against its plain version on the card, the limb and
    mode-map kernels at the K split they run at (``split_k``) and the plain
    versions summing the same per-split partials in the same order."""
    gen_cpu = torch.Generator().manual_seed(7)
    worst = {"quantize_mantissa": 0.0, "limb_matmul": 0.0, "tile_matmul": 0.0}
    worst_abs = dict(worst)
    n_cases = 0
    shapes = [(m, k, n) for m in MAIN_M for (k, n) in MAIN_KN + HYBRID_KN] + [(17, 33, 9)]
    tiny = dict(bm=16, bn=16, bk=16)
    splits = {}
    unsplit_vs_split = 0.0

    def hold(name, got, want, what):
        abs_err, err = _errs(got, want)
        worst[name] = max(worst[name], err)
        worst_abs[name] = max(worst_abs[name], abs_err)
        check(err <= MATMUL_TOL, f"{name} {what}: {err:.3e} > {MATMUL_TOL}")

    # quantize: bit-exact, three roundings x keep {3, 5, 7, 15}, with
    # specials; (257, 16, 16, 64) is the f32 upcast of one pool of the paged
    # phase, whose tier passes keep 5 and 3 bits
    for shape in ((4, 1024), (48, 2816), (1024, 2816), (17, 33), PAGED_POOL_SHAPE):
        x = _rand(gen, *shape)
        x.view(-1)[:6] = torch.tensor(
            [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-41], device="cuda")
        for rounding in ("grte", "trunc", "rne"):
            for keep in (3, 5, 7, 15):
                got = quantize_mantissa_op(x, keep, rounding)
                want = quantize_mantissa_plain(x, keep, rounding)
                torch.cuda.synchronize()
                same = torch.equal(got.view(torch.int32), want.view(torch.int32))
                check(same, f"quantize_mantissa {shape} {rounding} keep={keep} not bit-exact")
                n_cases += 1
    # the serving shapes at the default blocks, then ragged split layouts:
    # bk = 720 (not a multiple of TK = 64) puts a split boundary inside the
    # ragged last slab of K = 2816 (in both ladder bodies); bk = 16 < TK
    # makes every step a slab (at M = 3 and 16 in the skinny body, whose
    # 16-column map tiles cut its 64-column block, and at M = 17 and 70 in
    # the tensor-core tile body, whose 64 x 128 block they cut too); then
    # operands whose storage starts 4 bytes past a 16-byte boundary (the
    # 4-byte copies) in both ladder bodies
    cases = [(m, k, n, {}, False) for m, k, n in shapes] + [
        (4, 2816, 1024, dict(bk=720), False), (48, 2816, 1024, dict(bk=720), False),
        (17, 33, 9, tiny, False), (70, 300, 200, tiny, False),
        (3, 33, 9, tiny, False), (16, 33, 9, tiny, False), (4, 1024, 2816, {}, True),
        (48, 1024, 2816, {}, True), (65, 300, 200, tiny, True)]
    for m, k, n, blk, misaligned in cases:
        rand = _rand_misaligned if misaligned else _rand
        a, b = rand(gen, m, k), rand(gen, k, n)
        grid, (bm, bn, bk) = tile_grid(m, n, k, **blk)
        s = planned_splits(m, k, n, **blk)
        splits[f"{m}x{k}x{n}" + (f" {blk}" if blk else "")
               + (" misaligned" if misaligned else "")] = s
        if m == MAIN_M[0] and not blk and (k, n) in MAIN_KN:
            check(s > 1, f"no K split at the decode shape {(m, k, n)}")
        if blk.get("bk") == 720:
            walk = k_walk(k, bk, k_step(3))
            last = walk[-1][0]
            check(any(walk[t0 - 1][0] == walk[t0][0] == last
                      for t0, _ in split_ranges(len(walk), s)[1:]),
                  f"no split boundary inside the last slab at {(m, k, n)} bk={bk} S={s}")
        for limbs in (1, 2, 3):
            got = limb_matmul(a, b, limbs, **blk)
            again = limb_matmul(a, b, limbs, **blk)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"two limb_matmul calls differ at {(m, k, n)} k={limbs}")
            hold("limb_matmul", got, limb_matmul_plain(a, b, limbs, bk=bk, splits=s),
                 f"{(m, k, n)} {blk} k={limbs} S={s}")
            # uniform map == limb kernel, and runtime == static: bitwise
            uni = tile_matmul_mode(a, b, Mode(limbs), **blk)
            rt_host = tile_matmul_runtime(a, b, limbs, **blk)
            rt_dev = tile_matmul_runtime(
                a, b, torch.tensor(limbs, dtype=torch.int32, device="cuda"), **blk)
            torch.cuda.synchronize()
            check(torch.equal(uni, got), f"uniform map != limb kernel at {(m, k, n)} k={limbs}")
            check(torch.equal(rt_host, uni), f"runtime(host int) != static at {(m, k, n)} mode={limbs}")
            check(torch.equal(rt_dev, uni), f"runtime(device scalar) != static at {(m, k, n)} mode={limbs}")
            n_cases += 5
        # mixed maps, 2-D and 3-D, against the plain version; twice, bitwise
        for shape in (grid[:2], grid):
            mode_map = _mixed_map(shape, gen_cpu)
            got = tile_matmul(a, b, mode_map, **blk)
            again = tile_matmul(a, b, mode_map, **blk)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"two tile_matmul calls differ at {(m, k, n)}")
            hold("tile_matmul", got,
                 tile_matmul_plain(a, b, mode_map, kmax=3, bm=bm, bn=bn, bk=bk, splits=s),
                 f"{(m, k, n)} {blk} map{tuple(shape)} S={s}")
            n_cases += 2
        # the unsplit layout still holds: against its plain version and
        # against the planned split, and uniform == limb at one split too
        one = limb_matmul(a, b, 3, splits=1, **blk)
        torch.cuda.synchronize()
        hold("limb_matmul", one, limb_matmul_plain(a, b, 3, bk=bk), f"{(m, k, n)} {blk} S=1")
        _, err = _errs(one, limb_matmul(a, b, 3, **blk))
        unsplit_vs_split = max(unsplit_vs_split, err)
        check(err <= MATMUL_TOL, f"limb_matmul {(m, k, n)} {blk}: S=1 vs S={s} {err:.3e}")
        check(torch.equal(tile_matmul_mode(a, b, Mode.M24, splits=1, **blk), one),
              f"uniform map != limb kernel at {(m, k, n)} S=1")
        n_cases += 3
    # the other families' shapes (serve_moe, serve_configs, multimodal) at
    # the M their phases give, with fewer cases a shape: k = 2 and 3 (and 1
    # at M <= 16, the skinny body, with a second call bitwise) against the
    # plain version, uniform map == limb kernel and runtime (host int, device
    # scalar) == static bitwise, one mixed 2-D map against its plain version
    family_shapes = sorted({(m, k, n) for fam, (m_rows, kn) in FAMILY_SHAPES.items()
                            if fam != HYBRID_ARCH for m in m_rows for (k, n) in kn})
    for m, k, n in family_shapes:
        a, b = _rand(gen, m, k), _rand(gen, k, n)
        grid, (bm, bn, bk) = tile_grid(m, n, k)
        s = planned_splits(m, k, n)
        splits[f"{m}x{k}x{n}"] = s
        for limbs in (1, 2, 3) if m <= SKINNY_M_MAX else (2, 3):
            got = limb_matmul(a, b, limbs)
            if m <= SKINNY_M_MAX:
                again = limb_matmul(a, b, limbs)
                torch.cuda.synchronize()
                check(torch.equal(got, again),
                      f"two limb_matmul calls differ at {(m, k, n)} k={limbs}")
                n_cases += 1
            hold("limb_matmul", got, limb_matmul_plain(a, b, limbs, bk=bk, splits=s),
                 f"{(m, k, n)} k={limbs} S={s}")
            uni = tile_matmul_mode(a, b, Mode(limbs))
            rt_dev = tile_matmul_runtime(
                a, b, torch.tensor(limbs, dtype=torch.int32, device="cuda"))
            torch.cuda.synchronize()
            check(torch.equal(uni, got), f"uniform map != limb kernel at {(m, k, n)} k={limbs}")
            check(torch.equal(tile_matmul_runtime(a, b, limbs), uni),
                  f"runtime(host int) != static at {(m, k, n)} mode={limbs}")
            check(torch.equal(rt_dev, uni), f"runtime(device scalar) != static at {(m, k, n)}")
            n_cases += 4
        mode_map = _mixed_map(grid[:2], gen_cpu)
        hold("tile_matmul", tile_matmul(a, b, mode_map),
             tile_matmul_plain(a, b, mode_map, kmax=3, bm=bm, bn=bn, bk=bk, splits=s),
             f"{(m, k, n)} map{tuple(grid[:2])} S={s}")
        n_cases += 1
        del a, b
    n_cases += check_mma_rows(gen, gen_cpu, hold, splits,
                              {c[:3] for c in cases} | set(family_shapes))
    n_cases += captured_equals_eager(gen, gen_cpu)
    # a finer map grid than the default, so one launch holds many map tiles
    a, b = _rand(gen, 48, 1024), _rand(gen, 1024, 1024)
    grid, (bm, bn, bk) = tile_grid(48, 1024, 1024, bm=16, bn=64, bk=128)
    mode_map = _mixed_map(grid, gen_cpu)
    s = planned_splits(48, 1024, 1024, bm=16, bn=64, bk=128)
    splits["48x1024x1024 fine map"] = s
    hold("tile_matmul", tile_matmul(a, b, mode_map, bm=16, bn=64, bk=128),
         tile_matmul_plain(a, b, mode_map, kmax=3, bm=bm, bn=bn, bk=bk, splits=s),
         f"fine 3-D map S={s}")
    # ladder: error against f64 falls strictly k = 1 > 2 > 3
    a, b = _rand(gen, 48, 1024), _rand(gen, 1024, 2816)
    exact = a.double() @ b.double()
    ladder = [float((limb_matmul(a, b, kk).double() - exact).abs().max() / exact.abs().max())
              for kk in (1, 2, 3)]
    check(ladder[0] > ladder[1] > ladder[2], f"ladder not falling: {ladder}")
    # grte pre-pass composes the same way in both matmul wrappers
    check(torch.equal(limb_matmul(a, b, 2, rounding="grte"),
                      tile_matmul_mode(a, b, Mode.M16, rounding="grte")),
          "grte: uniform map != limb kernel")
    return {"cases": n_cases + 4, "max_rel_err": worst, "max_abs_err": worst_abs,
            "ladder_rel_err": ladder, "splits": splits,
            "unsplit_vs_split_rel_err": unsplit_vs_split}


def check_mma_rows(gen, gen_cpu, hold, splits: dict, done: set) -> int:
    """The tensor-core tile body at every M of ``MMA_ROWS`` over every held
    (K, N) not checked already (``done``): k = 2 and 3 (and 1 up to M = 65)
    against the plain version at the planned split, a second call bitwise,
    uniform map == limb kernel and runtime (host int, device scalar) ==
    static bitwise, one mixed 2-D map against its plain version.  Records
    each shape's split in ``splits``; returns the number of comparisons."""
    n_cases = 0
    kns = sorted(set(MAIN_KN) | set(HYBRID_KN)
                 | {kn for _, kns in FAMILY_SHAPES.values() for kn in kns})
    for m, (k, n) in itertools.product(MMA_ROWS, kns):
        if (m, k, n) in done:
            continue
        check(gemm_body(m, 3) == "mma", f"{(m, k, n)} does not run the tensor-core tile body")
        a, b = _rand(gen, m, k), _rand(gen, k, n)
        grid, (bm, bn, bk) = tile_grid(m, n, k)
        s = planned_splits(m, k, n)
        splits[f"{m}x{k}x{n}"] = s
        for limbs in (1, 2, 3) if m <= 65 else (2, 3):
            got = limb_matmul(a, b, limbs)
            again = limb_matmul(a, b, limbs)
            uni = tile_matmul_mode(a, b, Mode(limbs))
            rt_host = tile_matmul_runtime(a, b, limbs)
            rt_dev = tile_matmul_runtime(
                a, b, torch.tensor(limbs, dtype=torch.int32, device="cuda"))
            torch.cuda.synchronize()
            what = f"{(m, k, n)} k={limbs}"
            check(torch.equal(got, again), f"two limb_matmul calls differ at {what}")
            hold("limb_matmul", got, limb_matmul_plain(a, b, limbs, bk=bk, splits=s),
                 f"{what} S={s}")
            check(torch.equal(uni, got), f"uniform map != limb kernel at {what}")
            check(torch.equal(rt_host, uni), f"runtime(host int) != static at {what}")
            check(torch.equal(rt_dev, uni), f"runtime(device scalar) != static at {what}")
            n_cases += 5
        mode_map = _mixed_map(grid[:2], gen_cpu)
        hold("tile_matmul", tile_matmul(a, b, mode_map),
             tile_matmul_plain(a, b, mode_map, kmax=3, bm=bm, bn=bn, bk=bk, splits=s),
             f"{(m, k, n)} map{tuple(grid[:2])} S={s}")
        n_cases += 1
        del a, b
    return n_cases


def captured_equals_eager(gen, gen_cpu) -> int:
    """At M <= 16 (one and two activation fragments, a 16-column map tile):
    the limb kernel, the map kernel under a device-scalar mode and under a
    mixed map, captured together in one CUDA graph after an eager warm-up as
    the engine captures its steps; the replay's results must equal the
    eager launches' bit for bit.  Returns the number of comparisons."""
    n_cmp = 0
    for m, k, n, blk in ((4, 1024, 2816, {}), (12, 1024, 1024, {}), (1, 896, 128, {}),
                         (16, 33, 9, dict(bm=16, bn=16, bk=16))):
        a, b = _rand(gen, m, k), _rand(gen, k, n)
        grid, _ = tile_grid(m, n, k, **blk)
        mode_map = _mixed_map(grid, gen_cpu)
        mode = torch.tensor(3, dtype=torch.int32, device="cuda")
        calls = (lambda: limb_matmul(a, b, 2, **blk),
                 lambda: tile_matmul_runtime(a, b, mode, **blk),
                 lambda: tile_matmul(a, b, mode_map, **blk))
        eager_out = [f() for f in calls]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for f in calls:
                f()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = [f() for f in calls]
        graph.replay()
        torch.cuda.synchronize()
        for got, want, what in zip(captured, eager_out, ("limb", "runtime map", "mixed map")):
            check(torch.equal(got, want), f"captured {what} != eager at {(m, k, n)} {blk}")
            n_cmp += 1
        del graph
    return n_cmp


def _rand_misaligned(gen, *shape):
    """A contiguous operand whose storage starts 4 bytes past a 16-byte
    boundary: the double-f32 kernel and the skinny and tensor-core tile
    bodies must take their 4-byte load and copy paths."""
    n = math.prod(shape)
    x = torch.empty(n + 1, device="cuda", dtype=torch.float32)[1:].view(*shape)
    x.copy_(_rand(gen, *shape))
    check(x.data_ptr() % 16 != 0, "the misaligned operand is 16-byte aligned")
    return x


def hold_dd(a, b, limbs: int, splits: int, blk: dict) -> tuple[dict, torch.Tensor, float]:
    """One double-f32 launch at ``splits`` held against an f64 product, |lo|
    against max|hi|, the plain version at the same split folding at the
    kernel's K step, and a second call bitwise.  Returns the case's numbers,
    (hi + lo) in f64 and the result's scale."""
    m, k = a.shape
    n = b.shape[1]
    hi, lo = limb_matmul_dd(a, b, limbs, splits=splits, **blk)
    hi2, lo2 = limb_matmul_dd(a, b, limbs, splits=splits, **blk)
    torch.cuda.synchronize()
    what = f"limb_matmul_dd {(m, k, n)} {blk} k={limbs} S={splits}"
    check(torch.equal(hi, hi2) and torch.equal(lo, lo2), f"{what}: two calls differ")
    _, (_, _, bk) = tile_grid(m, n, k, **blk)
    p_hi, p_lo = limb_matmul_dd_plain(a, b, limbs, bk=bk, fold=k_step(limbs), splits=splits)
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    got = hi.double() + lo.double()
    f64_err = float((got - exact).abs().max()) / scale
    plain_abs = float((got - (p_hi.double() + p_lo.double())).abs().max())
    lo_ratio = float(lo.abs().max() / hi.abs().max())
    check(f64_err <= DD_F64_TOL, f"{what}: {f64_err:.3e} of scale from f64 > {DD_F64_TOL:.3e}")
    check(lo_ratio < DD_LO_RATIO, f"{what}: |lo|/max|hi| = {lo_ratio:.3e}")
    check(plain_abs / scale <= DD_TOL,
          f"{what}: {plain_abs / scale:.3e} of scale from the plain version > {DD_TOL:.3e}")
    return (dict(m=m, k=k, n=n, limbs=limbs, splits=splits, blk=blk, f64_rel_err=f64_err,
                 vs_plain_abs_err=plain_abs, vs_plain_rel_err=plain_abs / scale,
                 lo_over_hi=lo_ratio), got, scale)


def split_composition_mismatches(a, b, limbs: int, splits: int, blk: dict, hi, lo) -> int:
    """Elements where the kernel's result at ``splits`` (``hi``, ``lo``) is not
    exactly its own per-split pairs folded by ``reduce_splits_dd``.  Split s's
    pair is the unsplit kernel on ``a`` with every K column outside the
    split's range zeroed: the same walk, the same partials in its steps and
    exact zeros elsewhere, which leave a (sum, compensation) pair as it is.
    So any change to the reduction's rule or order, or to the split ranges,
    shows as a mismatch, however small."""
    m, k = a.shape
    _, (_, _, bk) = tile_grid(m, b.shape[1], k, **blk)
    pairs = []
    for pieces in split_pieces(k, bk, k_step(limbs), splits):
        masked = torch.zeros_like(a)
        k0, k1 = pieces[0][1], pieces[-1][2]
        masked[:, k0:k1] = a[:, k0:k1]
        pairs.append(limb_matmul_dd(masked, b, limbs, splits=1, **blk))
    want_hi, want_lo = reduce_splits_dd(pairs)
    return int(((hi != want_hi) | (lo != want_lo)).sum())


def split_vs_unsplit(got, unsplit, scale: float) -> float:
    """max |(hi + lo) at S - (hi + lo) at S = 1| over the result's scale."""
    return float((got - unsplit).abs().max()) / scale


def check_dd(gen) -> dict:
    """Hold the double-f32 kernel, at the K split it plans (``split_k``) and
    unsplit, at every DD case (``hold_dd``); split against unsplit within
    ``DD_SPLIT_TOL``, and every split result exactly equal to its own
    per-split pairs folded in order (``split_composition_mismatches``); then
    at forced splits (2 and the walk's length) at a ragged shape and at
    bk = 16 and 720, and on operands not 16-byte aligned (its 4-byte
    loads).  Then print its error beside the f32 limb kernel's at k = 3,
    K = 2816."""
    cases, vs_unsplit, compositions = [], [], 0
    forced = [((17, 33, 9, 4), dict(bm=16, bn=16, bk=16)),
              ((17, 33, 9, 3), dict(bm=16, bn=16, bk=16)), ((4, 2816, 1024, 4), dict(bk=720))]
    for (m, k, n, limbs), blk, misaligned in (
            [(c, {}, False) for c in DD_CASES] + [(c, blk, False) for c, blk in forced]
            + [((4, 1024, 1024, 4), {}, True), ((48, 2816, 1024, 6), {}, True)]):
        rand = _rand_misaligned if misaligned else _rand
        a, b = rand(gen, m, k), rand(gen, k, n)
        _, (_, _, bk) = tile_grid(m, n, k, **blk)
        planned = planned_splits(m, k, n, limbs, dd=True, **blk)
        walk = len(k_walk(k, bk, k_step(limbs)))
        if (m, k, n, limbs) == (4, 2816, 1024, 4) and not blk:
            check(planned > 1, f"no K split for the double-f32 kernel at {(m, k, n)}")
        extra = {2, walk} if blk or (m, k, n) == (17, 33, 9) else set()
        held = {s: hold_dd(a, b, limbs, s, blk)
                for s in sorted({1, planned} | {s for s in extra if s <= walk})}
        _, unsplit, scale = held[1]
        for s, (row, got, _) in held.items():
            row.update(planned=planned, misaligned=misaligned)
            if s > 1:
                what = f"limb_matmul_dd {(m, k, n)} {blk} k={limbs} S={s}"
                err = split_vs_unsplit(got, unsplit, scale)
                check(err <= DD_SPLIT_TOL, f"{what}: vs S=1 {err:.3e} > {DD_SPLIT_TOL:.3e}")
                hi, lo = limb_matmul_dd(a, b, limbs, splits=s, **blk)
                bad = split_composition_mismatches(a, b, limbs, s, blk, hi, lo)
                check(bad == 0, f"{what}: {bad} elements differ from its per-split pairs "
                                "folded in order")
                vs_unsplit.append(err)
                compositions += 1
                row["vs_unsplit_rel_err"] = err
            cases.append(row)
    side_by_side = []
    for m in MAIN_M:
        a, b = _rand(gen, m, 2816), _rand(gen, 2816, 1024)
        exact = a.double() @ b.double()
        scale = float(exact.abs().max())
        hi, lo = limb_matmul_dd(a, b, 3)
        side_by_side.append(dict(
            m=m, k=2816, n=1024, limbs=3,
            dd_f64_rel_err=float((hi.double() + lo.double() - exact).abs().max()) / scale,
            limb_f64_rel_err=float((limb_matmul(a, b, 3).double() - exact).abs().max()) / scale))
    return {"cases": cases, "tolerance_vs_f64": DD_F64_TOL, "lo_ratio": DD_LO_RATIO,
            "tolerance_vs_plain": DD_TOL, "tolerance_split_vs_unsplit": DD_SPLIT_TOL,
            "split_compositions_exact": compositions,
            "max_abs_err": max(c["vs_plain_abs_err"] for c in cases),
            "max_rel_err": max(c["vs_plain_rel_err"] for c in cases),
            "max_f64_rel_err": max(c["f64_rel_err"] for c in cases),
            "max_lo_over_hi": max(c["lo_over_hi"] for c in cases),
            "max_split_vs_unsplit_rel_err": max(vs_unsplit),
            "dd_vs_limb_k3": side_by_side}


def drive_dd_entry_point(gen) -> int:
    """The double-f32 kernel's path: its public entry point at the serving
    shapes at M32 and M48, with the launch counts zeroed just before and read
    just after."""
    operands = [(_rand(gen, m, k), _rand(gen, k, n), limbs)
                for limbs in (4, 6) for m in MAIN_M for (k, n) in MAIN_KN]
    build.reset_launch_counts()
    for a, b, limbs in operands:
        limb_matmul_dd(a, b, limbs)
    torch.cuda.synchronize()
    launches = build.launch_counts()["limb_matmul_dd"]
    check(launches == len(operands), f"limb_matmul_dd launched {launches} times")
    return launches


def decode_attention_case(slots: int, rows: int, hkv: int, g: int, hd: int, seed: int = 0):
    """q and a per-slot bf16 cache whose slots hold ShareGPT-like contexts:
    lognormal (sigma 1) with a mean of about 620 tokens (161 in and 338 out
    a request, each slot part way through its answer), cut to the cache."""
    rng = np.random.default_rng(seed)
    contexts = [int(min(rows, max(1, round(x))))
                for x in rng.lognormal(math.log(620.0) - 0.5, 1.0, slots)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((slots, 1, hkv * g, hd), generator=gen, device="cuda")
    k, v = (torch.randn((slots, rows, hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    pos = torch.full((slots, rows), -1, dtype=torch.int32, device="cuda")
    for i, n in enumerate(contexts):
        pos[i, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    qpos = torch.tensor(contexts, dtype=torch.int32, device="cuda") - 1
    return q, k, v, qpos, pos, contexts


def check_decode_attention() -> dict:
    """The decode-attention kernel against its plain version at both cells'
    shapes at M8, M16 and M24 (``held_to_plain``: each element within what
    p's other split allows, and as accurate as the plain version against
    float64), planted faults refused at each mode (one key too few, the
    neighbouring modes), modes bound as device scalars equal to the same
    host modes, and ``flash_attention`` at M16 on the limb kernel's policy:
    one launch, the wrapper's bits."""
    worst, cases = 0.0, []
    for cell, slots, rows, hkv, g, hd in DECODE_ATTN_SHAPES:
        q, k, v, qpos, pos, _ = decode_attention_case(slots, rows, hkv, g, hd)
        exact, wabs = attention_f64(q, k, v, qpos, pos)
        dropped = drop_top_key(q, k, qpos, pos)
        scalar = torch.zeros((), dtype=torch.int32, device="cuda")
        for i, mode in enumerate(F32_MODES):
            plain = decode_attention_plain(q, k, v, qpos, pos, qk_mode=mode, av_mode=mode)
            got = decode_attention(q, k, v, qpos, pos, qk_mode=mode, av_mode=mode)
            res = held_to_plain(got, plain, exact, wabs, qk_mode=mode, av_mode=mode)
            check(res["ok"], f"decode_attention {cell} {mode.name}: {res}")
            worst = max(worst, res["max_err_over_bound"])
            planted = {"key_dropped": decode_attention(q, k, v, qpos, dropped, qk_mode=mode,
                                                       av_mode=mode)}
            for j in (i - 1, i + 1):
                if 0 <= j < len(F32_MODES):
                    planted[F32_MODES[j].name] = decode_attention(q, k, v, qpos, pos,
                                                              qk_mode=F32_MODES[j],
                                                              av_mode=F32_MODES[j])
            refused = {}
            for name, bad in planted.items():
                r = held_to_plain(bad, plain, exact, wabs, qk_mode=mode, av_mode=mode)
                check(not r["ok"], f"decode_attention {cell} {mode.name}: planted {name} "
                                   f"passed {r}")
                refused[name] = {key: r[key] for key in ("max_err_over_bound", "rms_err")}
            scalar.fill_(int(mode))
            check(torch.equal(got, decode_attention(q, k, v, qpos, pos, qk_mode=scalar,
                                                    av_mode=scalar)),
                  f"decode_attention {cell} {mode.name}: a device-scalar mode differs")
            cases.append(dict(cell=cell, mode=mode.name, **res, planted_refused=refused))
        before = build.launch_counts()["decode_attention"]
        via = layers.flash_attention(q, k, v, PrecisionPolicy(default=Mode.M16, impl="pallas"),
                                     q_offset=qpos, kv_positions=pos)
        check(build.launch_counts()["decode_attention"] == before + 1,
              f"flash_attention at {cell}'s shape did not launch the decode-attention kernel")
        check(torch.equal(via, decode_attention(q, k, v, qpos, pos, qk_mode=Mode.M16,
                                                av_mode=Mode.M16)),
              "flash_attention's route differs from the wrapper")
        del q, k, v, exact, wabs
    return {"max_err_over_bound": worst, "cases": cases}


def check_decode_attention_replays(eng, what: str) -> None:
    """Each compiled step of an engine whose attention sites are bound at
    run time launches the decode-attention kernel once a layer a replay."""
    n = eng.model.cfg.n_layers
    for g in ("_step_graph", "_probe_graph"):
        per = getattr(eng, g).launches.get("decode_attention", 0)
        check(per == n, f"{what}: a {g} replay launches the decode-attention kernel {per} "
                        f"times for {n} layers")


def time_decode_attention() -> list[dict]:
    """The decode-attention kernel at both cells' shapes (M16, ShareGPT-like
    contexts) beside its bound (each valid K and V row read once, q read and
    the output written once, at the memory rate), its plain version, and one
    ``scaled_dot_product_attention`` call in bf16 with a boolean mask (a
    yardstick only: the port never calls it).  Operand copies rotate past the
    L2 cache, as a decode step finds the cache: cold."""
    rows_out = []
    for cell, slots, rows, hkv, g, hd in DECODE_ATTN_SHAPES:
        q, k, v, qpos, pos, contexts = decode_attention_case(slots, rows, hkv, g, hd)
        n_rot = n_rotations(2 * k.nbytes)
        ks = [k] + [k.clone() for _ in range(n_rot - 1)]
        vs = [v] + [v.clone() for _ in range(n_rot - 1)]
        kw = dict(qk_mode=Mode.M16, av_mode=Mode.M16)
        ms, enqueue = time_ms(lambda i: decode_attention(q, ks[i], vs[i], qpos, pos, **kw), n_rot)
        plain_ms, _ = time_ms(
            lambda i: decode_attention_plain(q, ks[i], vs[i], qpos, pos, **kw), n_rot,
            warmup=1, reps=2, samples=3)
        valid_bytes = 2 * sum(contexts) * hkv * hd * 2
        bound_ms = (valid_bytes + 2 * q.nbytes) / HBM_BW * 1e3
        qt = q.transpose(1, 2).to(torch.bfloat16)
        lib_kv = [(x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous(),
                   y.transpose(1, 2).repeat_interleave(g, dim=1).contiguous())
                  for x, y in zip(ks, vs)]
        mask = ((pos >= 0) & (pos <= qpos[:, None]))[:, None, None, :]
        library_ms, _ = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            qt, lib_kv[i][0], lib_kv[i][1], attn_mask=mask), n_rot)
        rows_out.append(dict(
            kernel="decode_attention", cell=cell, slots=slots, rows=rows, kv_heads=hkv,
            group=g, head_dim=hd, limbs=2, contexts=contexts, valid_kv_bytes=valid_bytes,
            ms=ms, enqueue_ms=enqueue, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
            library_ms=library_ms,
            library_is="torch scaled_dot_product_attention, bf16, boolean mask"))
        del ks, vs, lib_kv
    return rows_out


def time_dd(gen) -> list[dict]:
    """Time the double-f32 kernel at every DD case, at its planned K split
    and unsplit (``splits=1``) in the same run, beside its bound, its plain
    version at the planned split folding at the kernel's K step, and one
    torch.matmul in f32 and in f64 (what an M32/M48 user would otherwise
    call).  Operands smaller than the L2 cache rotate through at most 64
    copies and are read warm."""
    rows = []
    for m, k, n, limbs in DD_CASES:
        a = _rand(gen, m, k)
        n_rot = min(n_rotations(4 * k * n), 64)
        bs = [_rand(gen, k, n) for _ in range(n_rot)]
        a64, bs64 = a.double(), [x.double() for x in bs]
        _, (_, _, bk) = tile_grid(m, n, k)
        step = k_step(limbs)
        s = planned_splits(m, k, n, limbs, dd=True)
        bound, by = gemm_bound_ms(m, k, n, len(limb_product_terms(limbs)), outputs=2)
        ms1, enqueue1 = time_ms(lambda i: limb_matmul_dd(a, bs[i], limbs, splits=1), n_rot)
        ms, enqueue = time_ms(lambda i: limb_matmul_dd(a, bs[i], limbs), n_rot)
        plain, _ = time_ms(
            lambda i: limb_matmul_dd_plain(a, bs[i], limbs, bk=bk, fold=step, splits=s),
            n_rot, warmup=1, reps=2, samples=3)
        lib32, _ = time_ms(lambda i: torch.matmul(a, bs[i]), n_rot)
        lib64, _ = time_ms(lambda i: torch.matmul(a64, bs64[i]), n_rot)
        rows.append(dict(kernel="limb_matmul_dd", m=m, k=k, n=n, limbs=limbs, splits=s, ms=ms,
                         enqueue_ms=enqueue, ms_splits1=ms1, enqueue_ms_splits1=enqueue1,
                         plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib64,
                         library_f32_ms=lib32, library_bf16_ms=None))
        del bs, bs64
    return rows


def time_kernels(gen) -> dict:
    """Time every kernel at the serving path's shapes beside its bound, its
    plain version and the library's matmul at the same shape.  The limb and
    mode-map kernels are timed at their planned K split and, in the same
    run, unsplit (``splits=1``); the mode-map kernel both through
    ``tile_matmul_runtime`` (which fills a uniform map with ``torch.full``
    on every call) and through ``tile_matmul`` with the map built
    beforehand (the kernel alone)."""
    rows = []
    for m in MAIN_M:
        for (k, n) in MAIN_KN:
            a = _rand(gen, m, k)
            n_rot = n_rotations(4 * k * n)
            bs = [_rand(gen, k, n) for _ in range(n_rot)]
            bs16 = [x.to(torch.bfloat16) for x in bs]
            a16 = a.to(torch.bfloat16)
            grid, (bm, bn, bk) = tile_grid(m, n, k)
            lib32, _ = time_ms(lambda i: torch.matmul(a, bs[i]), n_rot)
            lib16, _ = time_ms(lambda i: torch.matmul(a16, bs16[i]), n_rot)
            for limbs in (2, 3):
                passes = len(limb_product_terms(limbs))
                bound, by = gemm_bound_ms(m, k, n, passes)
                s = planned_splits(m, k, n, limbs)
                common = dict(m=m, k=k, n=n, limbs=limbs, splits=s, bound_ms=bound,
                              bound_by=by, library_ms=lib32, library_bf16_ms=lib16)
                uniform = torch.full(grid[:2], limbs, dtype=torch.int32, device="cuda")
                plain, _ = time_ms(lambda i: limb_matmul_plain(a, bs[i], limbs, bk=bk, splits=s),
                                   n_rot)
                tile_plain, _ = time_ms(
                    lambda i: tile_matmul_plain(a, bs[i], uniform, kmax=3, bm=bm, bn=bn, bk=bk,
                                                splits=s), n_rot)
                for kernel, via, fn, p_ms in (
                        ("limb_matmul", "limb_matmul",
                         lambda i, sp=None: limb_matmul(a, bs[i], limbs, splits=sp), plain),
                        ("tile_matmul", "tile_matmul_runtime",
                         lambda i, sp=None: tile_matmul_runtime(a, bs[i], limbs, splits=sp),
                         tile_plain),
                        ("tile_matmul", "tile_matmul",
                         lambda i, sp=None: tile_matmul(a, bs[i], uniform, splits=sp),
                         tile_plain)):
                    ms1, enqueue1 = time_ms(lambda i: fn(i, 1), n_rot)
                    ms, enqueue = time_ms(fn, n_rot)
                    rows.append(dict(kernel=kernel, via=via, ms=ms, enqueue_ms=enqueue,
                                     ms_splits1=ms1, enqueue_ms_splits1=enqueue1,
                                     plain_ms=p_ms, **common))
            del bs, bs16
    rows += time_family_kernels(gen)
    # quantize pre-pass shapes: the activation and the weight of a site
    for shape in ((4, 1024), (1024, 2816)):
        nbytes = 4 * shape[0] * shape[1]
        n_rot = n_rotations(nbytes)
        xs = [_rand(gen, *shape) for _ in range(n_rot)]
        ms, enqueue = time_ms(lambda i: quantize_mantissa_op(xs[i], 15, "grte"), n_rot)
        plain, _ = time_ms(lambda i: quantize_mantissa_plain(xs[i], 15, "grte"), n_rot)
        rows.append(dict(
            kernel="quantize_mantissa", m=shape[0], k=None, n=shape[1], limbs=None,
            ms=ms, enqueue_ms=enqueue, plain_ms=plain,
            bound_ms=2.0 * nbytes / HBM_BW * 1e3, bound_by="bytes",
            library_ms=None, library_bf16_ms=None))
        del xs
    # the f32 rate 'native' is charged at, beside a measured f32 matmul
    big = 4096
    x, y = _rand(gen, big, big), _rand(gen, big, big)
    f32_ms, _ = time_ms(lambda i: torch.matmul(x, y))
    f32_rate = 2.0 * big**3 / (f32_ms * 1e-3)
    return {"rows": rows,
            "f32_matmul_4096": {"ms": f32_ms, "flop_per_s": f32_rate,
                                "datasheet_flop_per_s": F32_FLOPS}}


def time_family_kernels(gen) -> list[dict]:
    """The limb and mode-map kernels at the other families' GEMM shapes (by
    FAMILY_SHAPES, k = 2 and 3, the planned K split), beside the
    bound, the plain version and one f32 ``torch.matmul``; fewer samples
    than the main shapes' (no unsplit run).  Each row names the first
    family the shape is timed for."""
    rows = []
    timed = functools.partial(time_ms, warmup=2, reps=5, samples=3)
    seen = set()
    for fam, (m_rows, kn) in FAMILY_SHAPES.items():
        for m, (k, n) in ((m, kn_) for m in m_rows for kn_ in kn):
            if (m, k, n) in seen:
                continue
            seen.add((m, k, n))
            a = _rand(gen, m, k)
            n_rot = n_rotations(4 * k * n)
            bs = [_rand(gen, k, n) for _ in range(n_rot)]
            grid, (bm, bn, bk) = tile_grid(m, n, k)
            lib32, _ = timed(lambda i: torch.matmul(a, bs[i]), n_rot)
            for limbs in (2, 3):
                bound, by = gemm_bound_ms(m, k, n, len(limb_product_terms(limbs)))
                s = planned_splits(m, k, n, limbs)
                uniform = torch.full(grid[:2], limbs, dtype=torch.int32, device="cuda")
                plain, _ = timed(lambda i: limb_matmul_plain(a, bs[i], limbs, bk=bk, splits=s),
                                 n_rot)
                tile_plain, _ = timed(lambda i: tile_matmul_plain(
                    a, bs[i], uniform, kmax=3, bm=bm, bn=bn, bk=bk, splits=s), n_rot)
                for kernel, fn, p_ms in (
                        ("limb_matmul", lambda i: limb_matmul(a, bs[i], limbs), plain),
                        ("tile_matmul", lambda i: tile_matmul(a, bs[i], uniform), tile_plain)):
                    ms, enqueue = timed(fn, n_rot)
                    rows.append(dict(kernel=kernel, via=kernel, family=fam, m=m, k=k, n=n,
                                     limbs=limbs, splits=s, ms=ms, enqueue_ms=enqueue,
                                     plain_ms=p_ms, bound_ms=bound, bound_by=by,
                                     library_ms=lib32, library_bf16_ms=None))
            del bs
    return rows


def header_constants() -> dict[str, int]:
    """The ``constexpr int`` constants of ``csrc/rmpm_gemm.cuh``, evaluated
    in order (each an integer expression of earlier ones)."""
    with open(os.path.join(build.csrc_dir(), "rmpm_gemm.cuh")) as fh:
        text = fh.read()
    consts: dict[str, int] = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        consts[name] = eval(expr, {}, dict(consts))
    return consts


def body_ptxas(log: str, body: str) -> list[dict]:
    """ptxas's registers, spills and static shared memory for each
    instantiation of one ladder body of the limb and map kernels (``body``:
    ``"skinny"``, KMAX 1-3 x NF 1-2, or ``"mma"``, KMAX 1-3), beside the
    dynamic shared memory each launch asks for (``rmpm::SK_SMEM_BYTES``,
    ``rmpm::MM_SMEM_BYTES``)."""
    ring = header_constants()["SK_SMEM_BYTES" if body == "skinny" else "MM_SMEM_BYTES"]
    pattern = re.compile(rf"(limb|tile)_matmul_{body}_kernelILi(\d)E(?:Li(\d)E)?")
    out, cur = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kind = pattern.search(entry.group(1))
            cur = None
            if kind:
                cur = dict(kernel=f"{kind.group(1)}_matmul", kmax=int(kind.group(2)),
                           dynamic_smem_bytes=ring)
                if body == "skinny":
                    cur["nf"] = int(kind.group(3))
                out.append(cur)
        elif cur is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                cur.update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                smem = re.search(r"(\d+) bytes smem", line)
                cur.update(registers=int(used.group(1)),
                           static_smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def phase_kernels(gen) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    build.library(verbose=True)
    build_s = time.perf_counter() - t0
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1")
    checks = check_kernels(gen)
    dd = check_dd(gen)
    checks["max_abs_err"]["limb_matmul_dd"] = dd["max_abs_err"]
    checks["max_rel_err"]["limb_matmul_dd"] = dd["max_rel_err"]
    checks["entry_point_launches"] = {"limb_matmul_dd": drive_dd_entry_point(gen)}
    checks["decode_attention"] = check_decode_attention()
    timing = time_kernels(gen)
    timing["rows"] += time_dd(gen)
    timing["rows"] += time_decode_attention()
    for row in timing["rows"]:
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["path"] = ("wide" if row["kernel"] == "limb_matmul_dd"
                       else gemm_body(row["m"], row["limbs"])
                       if row["kernel"] in ("limb_matmul", "tile_matmul") else None)
    checks["ptxas_skinny"] = body_ptxas(build.BUILD_LOG, "skinny")
    check(len(checks["ptxas_skinny"]) == 12,
          f"{len(checks['ptxas_skinny'])} skinny instantiations in ptxas's log, not 12")
    checks["ptxas_mma"] = body_ptxas(build.BUILD_LOG, "mma")
    check(len(checks["ptxas_mma"]) == 6,
          f"{len(checks['ptxas_mma'])} tensor-core tile instantiations in ptxas's log, not 6")
    spilled = [p for p in checks["ptxas_mma"] if p["spill_stores"] or p["spill_loads"]]
    check(not spilled, f"tensor-core tile instantiations spill: {spilled}")
    check(build.BUILD_COUNT == 1, "kernels were built more than once")
    # ptxas -v per kernel: entry name, then registers / shared memory / spills
    ptxas = [ln.split(":", 1)[-1].strip() for ln in build.BUILD_LOG.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    emit("kernels", build_s=build_s, build_count=build.BUILD_COUNT,
         kernels=sorted(KERNEL_INFO), tolerance=MATMUL_TOL, dd=dd, **checks,
         kernel_ms=timing["rows"], f32_matmul_4096=timing["f32_matmul_4096"], ptxas=ptxas,
         sms=torch.cuda.get_device_properties(0).multi_processor_count)
    return checks, timing


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------


def full_width_model(policy: PrecisionPolicy, n_layers: int | None = None, arch: str = ARCH):
    cfg = get_config(arch).with_policy(policy)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return build_model(cfg)  # device=None: the GPU, or raise


def time_prefills(eng) -> None:
    """Sum the host wall time of the engine's prefills (each ends in a
    sync) into ``eng.prefill_s``, so a phase can say what share of its wall
    time the eager prefill takes.  The hook holds the engine weakly, so it
    adds no reference cycle: a dropped engine is freed at once."""
    eng.prefill_s = 0.0
    prefill = type(eng)._prefill_slot
    ref = weakref.ref(eng)

    def timed(*args):
        e = ref()
        t0 = time.perf_counter()
        first = prefill(e, *args)
        e.prefill_s += time.perf_counter() - t0
        return first

    eng._prefill_slot = timed


def retire(holder: dict, key) -> dict:
    """Drop the engine ``holder[key]`` (its last reference) and measure what
    that frees: with the cycle collector off, the engine must die at once,
    and with it its graphs' memory pool (``repro_torch.serve.graphs``);
    ``empty_cache`` then hands the pool's memory back to the card.  Returns
    the reserved and allocated memory freed (GB)."""
    torch.cuda.synchronize()
    reserved0, alloc0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    gc.disable()
    try:
        ref = weakref.ref(holder.pop(key))
        alive = ref() is not None
    finally:
        gc.enable()
    torch.cuda.empty_cache()
    check(not alive, f"engine {key!r} outlived its last reference (a reference cycle)")
    return {"reserved_freed_gb": (reserved0 - torch.cuda.memory_reserved()) / 1e9,
            "allocated_freed_gb": (alloc0 - torch.cuda.memory_allocated()) / 1e9,
            "reserved_after_gb": torch.cuda.memory_reserved() / 1e9}


def serve(model, params, config: ServeConfig, reqs: list[Request], seed: int,
          eager_run: bool = False):
    """Serve copies of ``reqs`` through run_open_loop with the launch counts
    zeroed just before and read just after; the compiled steps are captured
    and replayed, or run eagerly with ``eager_run``.  Returns (engine,
    outputs, counts, s)."""
    eng = ServeEngine(model, params, config=config)
    time_prefills(eng)
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with eager() if eager_run else contextlib.nullcontext():
        outs = run_open_loop(eng, [dataclasses.replace(r) for r in reqs], 0.0, rng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    for r in reqs:
        check(r.rid in outs, f"request {r.rid} did not complete")
        budget = eng.scheduler.tickets[r.rid].budget
        check(len(outs[r.rid]) == budget,
              f"request {r.rid}: {len(outs[r.rid])} tokens, budget {budget}")
        check(all(0 <= t < model.cfg.vocab for t in outs[r.rid]),
              f"request {r.rid}: token out of range")
    check(eng.graph_capture_count == (0 if eager_run else 1),
          f"{eng.graph_capture_count} CUDA graphs captured (eager={eager_run})")
    return eng, outs, counts, wall


def check_same_tokens(got: dict, want: dict, what: str) -> None:
    """Request by request, the same tokens (captured against eager)."""
    check(sorted(got) == sorted(want), f"{what}: different requests completed")
    for rid in want:
        check(got[rid] == want[rid], f"{what}: request {rid} differs")


def solo_tokens(model, params, req: Request, max_len: int) -> list[int]:
    """The port's own solo decode of one request: a 1-slot engine."""
    eng = ServeEngine(model, params, config=ServeConfig(batch_slots=1, max_len=max_len))
    return eng.generate_batch([Request(req.prompt, req.max_new, rid=req.rid)])[req.rid]


def serve_summary(eng, outs, wall) -> dict:
    s = eng.metrics.summary()
    total = sum(len(v) for v in outs.values())
    steps = [g for g in (eng._step_graph, eng._round_graph, eng._probe_graph) if g is not None]
    prefill_s = getattr(eng, "prefill_s", None)
    return {"requests": len(outs), "tokens": total, "wall_s": wall,
            "prefill_s": prefill_s,
            "prefill_share": None if prefill_s is None else prefill_s / wall,
            "graph_captures": eng.graph_capture_count,
            "capture_s": {g.name: g.capture_s for g in steps if g.capture_s is not None},
            "tok_per_s": total / wall, "ttft_s_mean": s.get("ttft_mean_s"),
            "ttft_s_max": max(eng.metrics.ttft(rid) for rid in outs),
            "decode_steps": s.get("decode_steps"),
            "occupancy": s.get("occupancy"),
            "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def replay_event_ms(fn, reps: int = 5) -> float:
    """CUDA events around one ``fn()`` (one graph replay: the whole step is
    queued at once, so the events bracket its device time), median of
    ``reps`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def step_breakdown(model, params, slots: int = 4, prompt_len: int = 48,
                   max_len: int = 96, bound_logits: bool = True, sites=None) -> dict:
    """Where one decode step and one prefill spend their time.  The decode
    step is the engine's compiled step on a 4-slot engine whose rows hold
    24 cached tokens, run captured (one graph replay) and eagerly
    (``graphs.eager()``), in the order eager / captured / captured / eager:
    wall time of each (host clock around a synchronised call, median of 5),
    the share of a step's wall time in which the card was busy and the
    device ms per step (sum of device kernel times from ``torch.profiler``),
    the replay's device time by CUDA events, the step's split-K reductions
    (``splitk_reduce``) from the profiler, and the device time of the
    state's copy-back (the masked merge and ``copy_`` of every leaf that
    ends each step).  Beside it: one 48-token prefill (eager), the logits
    site alone (bound to a host int and to a device scalar, unless
    ``bound_logits`` is false), and kernel launches per call.  ``sites``: a
    context factory yielding the CUDA event pairs some sites record (as
    ``moe_expert_events``); three more eager steps run inside it, and the
    pairs' summed device ms per step is ``eager_sites``."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    vocab, d = model.cfg.vocab, model.cfg.d_model
    prompt = torch.randint(0, vocab, (1, prompt_len), generator=gen, device="cuda")
    solo0 = model.init_decode_state(1, max_len, per_slot=True)
    x_dec = torch.randn((slots, 1, d), generator=gen, device="cuda")
    x_pre = torch.randn((1, prompt_len, d), generator=gen, device="cuda")
    eng = ServeEngine(model, params, config=ServeConfig(batch_slots=slots, max_len=max_len))
    rng = np.random.default_rng(11)
    for i in range(slots):
        eng.submit(Request(rng.integers(0, vocab, prompt_len // 2).astype(np.int32),
                           max_len, rid=i))
    eng.step()  # every slot prefilled, then the first decode step: warm-up, capture
    step = eng._step_graph
    check(step is not None and step.captures == 1, "the decode step was not captured")

    def eager_step():
        with eager():
            step()

    before = build.launch_counts()
    eager_step()
    mid = build.launch_counts()
    model.decode_step(params, prompt, solo0)
    after = build.launch_counts()
    walls = {"eager": [], "captured": []}
    for label in ("eager", "captured", "captured", "eager"):
        walls[label].append(wall_ms(eager_step if label == "eager" else step))
    out = {
        "slots": slots, "prompt_len": prompt_len, "cache_len": prompt_len // 2,
        "decode_step_ms_captured": walls["captured"],
        "decode_step_ms_eager": walls["eager"],
        "decode_step_ms": statistics.median(walls["captured"]),
        "replay_event_ms": replay_event_ms(step),
        "capture_s": step.capture_s,
        "decode_logits_ms": wall_ms(lambda: model._logits(params, x_dec)),
        "prefill_ms": wall_ms(lambda: model.decode_step(params, prompt, solo0)),
        "prefill_logits_ms": wall_ms(lambda: model._logits(params, x_pre)),
        "launches_per_decode_step": dict(step.launches),
        "launches_per_decode_step_eager": {k: mid[k] - before[k] for k in mid},
        "launches_per_prefill": {k: after[k] - mid[k] for k in mid},
    }
    check(out["launches_per_decode_step"] == out["launches_per_decode_step_eager"],
          "a replay records other launches than an eager step makes")
    steps = 3
    for label, fn in (("captured", step), ("eager", eager_step)):
        prof = device_busy(fn, steps)
        reduce = [e for e in prof["events"] if "splitk_reduce" in e.key and "_dd" not in e.key]
        out[label] = {
            "profiled_decode_steps": steps,
            "device_busy_share_under_profiler": prof["busy"],
            "device_ms_per_decode_step": prof["device_ms"],
            "top_device_kernels": prof["top"],
            "splitk_reduce_calls_per_step": sum(e.count for e in reduce) / steps,
            "splitk_reduce_device_ms_per_step":
                sum(e.device_time_total for e in reduce) / steps / 1e3,
        }
    if sites is not None:
        with sites() as pairs:
            for _ in range(steps):
                eager_step()
        torch.cuda.synchronize()
        out["eager_sites"] = {
            "decode_steps": steps, "calls_per_step": len(pairs) / steps,
            "device_ms_per_step": sum(a.elapsed_time(b) for a, b in pairs) / steps}
    # the logits site bound to a run-time mode: as a host int it runs the
    # mode's own products; as a device scalar (what a captured modal step
    # binds) it makes all six products of the ladder's top and selects
    for mode in (Mode.M8, Mode.M16, Mode.M24) if bound_logits else ():
        dev_mode = torch.tensor(int(mode), dtype=torch.int32, device="cuda")
        for label, bound in (("host_int", int(mode)), ("device_scalar", dev_mode)):
            def logits_at(i, bound=bound):
                with bind_modes({"logits": bound}):
                    model._logits(params, x_dec)
            ms, _ = time_ms(logits_at, warmup=1, reps=3, samples=3)
            out.setdefault("bound_logits_device_ms", {})[f"{mode.name} {label}"] = ms
    # the copy-back alone, captured on its own as the step captures it: one
    # step's new state merged into (clones of) the static state and copied
    # there, as the end of every compiled step does
    _, new_state = model.decode_step(params, eng._tokens, eng.state)
    dst = map_state(lambda x: x.clone(), eng.state)

    def copy_back():
        copy_state_(dst, eng._merge(new_state, dst, eng._active_dev))

    copy_back()  # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        copy_back()
    out["state_copy_back"] = {
        "replay_event_ms": replay_event_ms(graph.replay),
        "eager_wall_ms": wall_ms(copy_back),
        "kernels": 2 * len(state_leaves(eng.state)),
        "bytes": sum(x.numel() * x.element_size() for x in state_leaves(eng.state))}
    wall = statistics.median(walls["captured"])
    for label in ("captured", "eager"):
        # kernel time over the un-profiled wall (the profiler slows the host)
        out[label]["device_busy_share"] = (
            out[label]["device_ms_per_decode_step"] / statistics.median(walls[label])
            if out[label]["device_ms_per_decode_step"] else None)
    out["replay_gap_ms"] = wall - out["replay_event_ms"]
    return out


def device_busy(fn, calls: int) -> dict:
    """``fn`` run ``calls`` times under ``torch.profiler``: the share of the
    wall time in which the card ran a kernel (``busy``: sum of device kernel
    times over the wall), device ms per call, the six kernels with the most
    device time and every device event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:6]
    return {"busy": (busy_us / wall_us) if busy_us else None,
            "device_ms": (busy_us / calls / 1e3) if busy_us else None,
            "top": [{"name": e.key[:60], "calls_per_step": e.count / calls,
                     "device_ms_per_step": e.device_time_total / calls / 1e3}
                    for e in top],
            "events": events}


def phase_serve_static(params_cache, n_layers):
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    model = full_width_model(policy, n_layers)
    params = params_cache(model)
    reqs = ragged_requests(8, model.cfg.vocab, 48, 16, np.random.default_rng(0))
    cfg = ServeConfig(batch_slots=4, max_len=96)
    # eager / captured / captured / eager: the first captured run is the
    # main path (its launch counts go to the kernels line)
    runs = {}
    for label in ("eager", "captured", "captured_2", "eager_2"):
        e, o, c, w = serve(model, params, cfg, reqs, seed=0, eager_run=label.startswith("eager"))
        runs[label] = (e, o, c, w, serve_summary(e, o, w))
    eng, outs, counts, wall, _ = runs["captured"]
    for label, (_, other, _, _, _) in runs.items():
        check_same_tokens(other, outs, f"serve_static {label} against captured")
    check(counts["limb_matmul"] > 0, "serve_static launched the limb kernel no time")
    check(counts["tile_matmul"] == 0, "static policy reached the mode-map kernel")
    solo_ok = []
    for r in reqs[:2]:
        solo = solo_tokens(model, params, r, 96)
        check(solo == outs[r.rid], f"request {r.rid}: batched tokens != solo decode")
        solo_ok.append(r.rid)
    # one decode step's logits against the plain limb algebra ('xla') on the
    # same weights: the kernels and the plain version serve the same model
    ref_model = model.with_policy(PrecisionPolicy(default=Mode.M16, impl="xla"))
    toks = torch.as_tensor(np.asarray(reqs[0].prompt)[None, :], device="cuda")
    l_kernel, _ = model.decode_step(params, toks, model.init_decode_state(1, 96, per_slot=True))
    l_plain, _ = ref_model.decode_step(params, toks, ref_model.init_decode_state(1, 96, per_slot=True))
    check(bool(torch.isfinite(l_kernel).all()), "non-finite logits")
    check(tuple(l_kernel.shape) == (1, len(reqs[0].prompt), model.cfg.vocab), "logits shape")
    gap = float((l_kernel - l_plain).abs().max() / l_plain.std())
    check(gap < 1e-3, f"kernel-path logits differ from the plain limb algebra: {gap:.3e} of spread")
    emit("serve_static", arch=ARCH, layers=model.cfg.n_layers, d_model=model.cfg.d_model,
         vocab=model.cfg.vocab, policy=policy.describe(), launches=counts,
         solo_equal_rids=solo_ok, logits_gap_vs_plain_over_spread=gap,
         build_count=build.BUILD_COUNT, captured_tokens_equal_eager=True,
         **serve_summary(eng, outs, wall),
         runs={label: run[4] for label, run in runs.items()},
         breakdown=step_breakdown(model, params))
    return counts


def adapt_run(model, params, cfg: ServeConfig, reqs: list[Request], eager_run: bool,
              time_steps: bool = False):
    """Serve ``reqs`` on an adaptive engine step by step, captured or eager,
    with the launch counts zeroed just before.  Prefill runs unbound (limb
    kernel), decode bound (mode-map kernel): a pure decode step must launch
    no limb kernel.  After the third decode step every site is shifted one
    mode down (besides the controller's own shifts), so the run crosses at
    least one shift (one up if the controller already sat at the bottom).
    ``time_steps``: the decode step runs under a :class:`StepTimer`.
    Returns (engine, outputs, counts, s, capture counts
    seen after each step once both compiled steps had run)."""
    eng = ServeEngine(model, params, config=cfg)
    time_prefills(eng)
    if time_steps:
        eng._step_graph = StepTimer(eng, profile_steps=0)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    limb_after_prefill, captures, forced = None, set(), False
    t0 = time.perf_counter()
    with eager() if eager_run else contextlib.nullcontext():
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        while eng.scheduler.has_work():
            before = build.launch_counts()
            n_wait = eng.scheduler.n_waiting
            eng.step()
            after = build.launch_counts()
            if n_wait == 0:  # a pure decode step: no admission, so no prefill
                check(after["limb_matmul"] == before["limb_matmul"],
                      "limb kernel launched during a bound decode step")
                limb_after_prefill = after["limb_matmul"]
            if eng.metrics.decode_steps and eng.controller.history:
                captures.add(eng.graph_capture_count)  # both steps have run
            if eng.metrics.decode_steps >= 3 and not forced:
                table = eng.mode_table
                forced = table.shift_all(1 if table.at_min else -1, tag="forced")
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(limb_after_prefill is not None, "no pure decode step ran")
    check(forced, "the forced mode shift did not move the table")
    return eng, outs, build.launch_counts(), wall, captures


def phase_serve_adapt(params_cache, n_layers):
    policy = PrecisionPolicy(default=Mode.M24, impl="pallas")
    model = full_width_model(policy, n_layers)
    params = params_cache(model)
    reqs = ragged_requests(4, model.cfg.vocab, 48, 16, np.random.default_rng(1))
    cfg = ServeConfig(batch_slots=4, max_len=96,
                      adapt=AdaptConfig(slo=SLO(max_err=0.05), adapt_every=2))
    eng, outs, counts, wall, captures = adapt_run(model, params, cfg, reqs, eager_run=False,
                                                  time_steps=True)
    e_eng, e_outs, _, e_wall, e_captures = adapt_run(model, params, cfg, reqs, eager_run=True)
    for r in reqs:
        check(len(outs[r.rid]) == eng.scheduler.tickets[r.rid].budget,
              f"request {r.rid} incomplete")
    check_same_tokens(outs, e_outs, "serve_adapt eager against captured")
    check(eng.metrics.mode_timeline == e_eng.metrics.mode_timeline,
          "serve_adapt: the captured and eager mode timelines differ")
    check(counts["tile_matmul"] > 0, "serve_adapt launched the mode-map kernel no time")
    check_decode_attention_replays(eng, "serve_adapt")
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1 after mode shifts")
    check(len(eng.controller.history) > 0, "no probe ran")
    # one graph per compiled step (decode step, probe) across every shift
    check(captures == {2} and eng.graph_capture_count == 2,
          f"capture counts {sorted(captures)} across mode shifts (want only 2)")
    check(e_captures == {0}, f"the eager run captured {sorted(e_captures)}")
    emit("serve_adapt", policy=policy.describe(), launches=counts,
         build_count=build.BUILD_COUNT, graph_capture_counts_seen=sorted(captures),
         probes=len(eng.controller.history),
         mode_switches=eng.mode_table.switches,
         mode_timeline=[[int(s), lab] for s, lab in eng.metrics.mode_timeline],
         adaptation=eng.describe_adaptation(), captured_tokens_equal_eager=True,
         replay=eng._step_graph.summary(),
         **serve_summary(eng, outs, wall), eager=serve_summary(e_eng, e_outs, e_wall))
    return counts


def phase_serve_grte(params_cache, n_layers):
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas", rounding="grte")
    model = full_width_model(policy, min(4, n_layers or 4))
    params = params_cache(model)
    reqs = ragged_requests(2, model.cfg.vocab, 48, 16, np.random.default_rng(2))
    cfg = ServeConfig(batch_slots=2, max_len=96)
    eng, outs, counts, wall = serve(model, params, cfg, reqs, seed=2)
    check(counts["quantize_mantissa"] > 0, "serve_grte launched the quantize kernel no time")
    check(counts["limb_matmul"] > 0, "serve_grte launched the limb kernel no time")
    emit("serve_grte", policy=policy.describe(), layers=model.cfg.n_layers,
         launches=counts, build_count=build.BUILD_COUNT,
         **serve_summary(eng, outs, wall))
    return counts


def phase_serve_planned(params_cache, n_layers):
    model = full_width_model(PrecisionPolicy(default=Mode.M24, impl="auto"), n_layers)
    params = params_cache(model)
    reqs = ragged_requests(4, model.cfg.vocab, 48, 16, np.random.default_rng(3))
    cfg = ServeConfig(batch_slots=4, max_len=96, accuracy=2.0**-12)
    eng, outs, counts, wall = serve(model, params, cfg, reqs, seed=3)
    emit("serve_planned", accuracy=2.0**-12, plans=eng.describe_plans().splitlines(),
         launches=counts, build_count=build.BUILD_COUNT,
         **serve_summary(eng, outs, wall))
    return counts


def phase_tune(params_cache):
    """The autotuner on the card over a small grid, its table saved, loaded
    and compared, then a full-width engine planned from it at a tightened
    accuracy: every site's plan with its cost source, beside the plan the
    data-sheet roofline makes.  What the tuned plans choose is printed, not
    asserted."""
    build.reset_launch_counts()
    t0 = time.perf_counter()
    table = tune((256, 1024), backend="gpu", modes=(Mode.M8, Mode.M16, Mode.M24), iters=3)
    tune_s = time.perf_counter() - t0
    launches = build.launch_counts()
    table.save(TUNE_TABLE_PATH)
    loaded = TuneTable.load(TUNE_TABLE_PATH)
    check(loaded.fingerprint == table.fingerprint, "tuning table changed on a save/load")
    check(launches["limb_matmul"] > 0 and launches["tile_matmul"] > 0,
          "the tuner measured neither kernel")
    best = {}
    for r in table.records:
        key = f"n={r.m} {r.mode}"
        if key not in best or r.wall_us < best[key]["wall_us"]:
            best[key] = {"impl": r.impl, "depth": r.depth, "block": r.block,
                         "wall_us": r.wall_us, "rel_err": r.rel_err}
    model = full_width_model(PrecisionPolicy(default=Mode.M24, impl="auto"))
    params = params_cache(model)

    def plans(tune_table):
        eng = ServeEngine(model, params, config=ServeConfig(
            batch_slots=4, max_len=96, accuracy=2.0**-12, tune_table=tune_table))
        return eng, {site: {"mode": p.mode.name, "impl": p.impl, "depth": p.strassen_depth,
                            "block": p.block, "source": p.source,
                            "t_us": p.t_resolved_s * 1e6}
                     for site, p in eng.plans.items()}

    eng, tuned = plans(TUNE_TABLE_PATH)
    _, roofline = plans(False)
    check(build.BUILD_COUNT == 1, "the tune phase rebuilt the kernel library")
    emit("tune", sizes=[256, 1024], modes=["M8", "M16", "M24"], iters=3, tune_s=tune_s,
         records=len(table.records), fingerprint=table.fingerprint, path=TUNE_TABLE_PATH,
         balance={"peak_flops": table.balance.peak_flops, "hbm_bw": table.balance.hbm_bw,
                  "source": table.balance.source},
         launches=launches, fastest_per_size_and_mode=best,
         plans=eng.describe_plans().splitlines(), tuned=tuned, roofline=roofline,
         changed_sites=sorted(site for site in tuned
                              if (tuned[site]["impl"], tuned[site]["depth"])
                              != (roofline[site]["impl"], roofline[site]["depth"])))


def phase_serve_spec(params_cache):
    """Self-speculative serving at full width and depth beside a plain arm
    over the same requests: identical tokens, acceptance above 0, one build.
    Also the host's cost of one draft substep, one verify substep and one
    round on a 4-slot state (wall clock around a synchronised call), and the
    device time of a round under the profiler."""
    policy = PrecisionPolicy(default=Mode.M24, impl="pallas")
    model = full_width_model(policy)
    params = params_cache(model)
    reqs = ragged_requests(8, model.cfg.vocab, 48, 16, np.random.default_rng(4))
    spec = SpecConfig(k=3, draft_shift=2)
    cfgs = {"plain": ServeConfig(batch_slots=4, max_len=96),
            "spec": ServeConfig(batch_slots=4, max_len=96, spec=spec)}
    arms = {}
    for name, eager_run in (("plain", False), ("spec", False), ("spec_eager", True),
                            ("plain_eager", True)):
        e, o, c, w = serve(model, params, cfgs[name.split("_")[0]], reqs, seed=4,
                           eager_run=eager_run)
        arms[name] = (e, o, c, w, serve_summary(e, o, w))
    eng, outs, counts, wall, summary = arms["spec"]
    _, base_outs, base_counts, base_wall, base_summary = arms["plain"]
    for r in reqs:
        check(outs[r.rid] == base_outs[r.rid],
              f"request {r.rid}: speculative tokens != plain tokens")
    check_same_tokens(arms["spec_eager"][1], outs, "serve_spec eager against captured")
    check_same_tokens(arms["plain_eager"][1], base_outs, "serve_spec plain eager against captured")
    s = eng.metrics.summary()
    check(s["acceptance_rate"] is not None and s["acceptance_rate"] > 0,
          f"acceptance {s['acceptance_rate']}")
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1 with speculation")
    check(counts["tile_matmul"] > 0 and counts["limb_matmul"] > 0,
          "the round missed the draft (mode-map) or the verify (limb) kernel")

    # host cost of the pieces of a round, on a 4-slot state of 24 cached tokens
    gen = torch.Generator(device="cuda").manual_seed(12)
    prompts = torch.randint(0, model.cfg.vocab, (4, 24), generator=gen, device="cuda")
    _, state = model.decode_step(params, prompts, model.init_decode_state(4, 96, per_slot=True))
    tok = torch.randint(0, model.cfg.vocab, (4, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    active = torch.ones(4, dtype=torch.bool, device="cuda")
    table = eng._spec_table
    draft, verify = table.scalars_shifted(-spec.draft_shift), table.scalars()

    def draft_substep():
        with bind_modes(draft):
            model.decode_step(params, tok, state)

    def one_round():
        eng._spec_round(params, tok, state, active, draft, verify)

    # the engine's compiled round (captured while serving), on its own static
    # inputs and state: one replay
    round_graph = eng._round_graph
    prof, prof_c = device_busy(one_round, 2), device_busy(round_graph, 2)
    substeps = {
        "draft_substep_ms": wall_ms(draft_substep),
        "verify_substep_ms": wall_ms(lambda: model.decode_step(params, tok, state)),
        "round_ms": wall_ms(one_round),
        "round_device_busy_share_under_profiler": prof["busy"],
        "round_device_ms": prof["device_ms"],
        "round_top_device_kernels": prof["top"],
        "round_captured_ms": wall_ms(round_graph),
        "round_captured_replay_event_ms": replay_event_ms(round_graph),
        "round_captured_device_busy_share_under_profiler": prof_c["busy"],
        "round_captured_device_ms": prof_c["device_ms"],
        "round_capture_s": round_graph.capture_s,
    }
    emit("serve_spec", arch=ARCH, layers=model.cfg.n_layers, policy=policy.describe(),
         k=spec.k, draft_shift_start=spec.draft_shift, draft_shift_end=eng.draft_shift,
         tokens_identical=True, acceptance=s["acceptance_rate"],
         verify_steps_per_token=s["verify_steps_per_token"], spec_rounds=s["spec_rounds"],
         draft_shift_timeline=eng.metrics.draft_shift_timeline,
         speculation=eng.describe_speculation(), build_count=build.BUILD_COUNT,
         spec_compile_count=eng.spec_compile_count,
         launches_spec=counts, launches_plain=base_counts,
         spec=summary, plain=base_summary, captured_tokens_equal_eager=True,
         spec_eager=arms["spec_eager"][4], plain_eager=arms["plain_eager"][4],
         tok_per_s_ratio=summary["tok_per_s"] / base_summary["tok_per_s"],
         tok_per_s_ratio_eager=(arms["spec_eager"][4]["tok_per_s"]
                                / arms["plain_eager"][4]["tok_per_s"]),
         host_cost_4_slots=substeps)
    return counts


def prefix_traffic(vocab: int, seed: int, n: int = 16) -> list[Request]:
    """``n`` requests whose prompts share a 32-token prefix (two pages of 16)
    and end in 8-24 tokens of their own, each asking for 16-32 new tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 32)
    return [Request(np.concatenate([prefix, rng.integers(0, vocab, int(rng.integers(8, 25)))])
                    .astype(np.int32), int(rng.integers(16, 33)), rid=i) for i in range(n)]


def pool_tensors(state) -> list[torch.Tensor]:
    return [getattr(n, f) for layers in state.caches.values() for n in layers
            for f in ("k_pool", "v_pool", "k_scale", "v_scale")
            if getattr(n, f, None) is not None]


def time_tier_passes(eng) -> tuple[list[dict], list[dict]]:
    """Wrap the engine's tier pass: each call runs under ``torch.profiler``
    (kernel time, launches) between CUDA events (its device span, which the
    pass's closing sync bounds) with the peak device memory it adds.  For
    the first pass at each (keep, next keep) that finds a cold page, it
    also keeps what that pass read and wrote on the group's first layer
    (both pools before and after, the masks and the keeps) for
    :func:`check_tier_passes`.  Returns (timing records, kept passes),
    filled as the engine runs."""
    from torch.profiler import ProfilerActivity, profile

    records, kept = [], []
    layout = eng.layout
    tick = layout.tier_tick

    def timed(state, lengths, step):
        tc = layout.tier_ctrl
        keeps = (tc.target_keep, tc.next_keep)
        first = None
        if lengths and keeps not in [r["keeps"] for r in kept]:
            demote, shadow = layout.tier_masks(lengths)
            if shadow[0].any():
                node = state.caches[layout.groups[0].key][0]
                first = {"keeps": keeps, "demote": demote[0], "shadow": shadow[0],
                         "node": node, "before": (node.k_pool.clone(), node.v_pool.clone())}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            out = tick(state, lengths, step)
            end.record()
            end.synchronize()
        wall = time.perf_counter() - t0
        if out[1] is not None:
            events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
            records.append({
                "step": step, "demoted": out[1]["demoted"], "err": out[1]["err"],
                "span_ms": start.elapsed_time(end), "wall_ms": wall * 1e3,
                "kernel_ms": sum(e.device_time_total for e in events) / 1e3,
                "kernels": sum(e.count for e in events),
                "quantize_kernel_ms": sum(e.device_time_total for e in events
                                          if "quantize" in e.key) / 1e3,
                "peak_extra_mb": (torch.cuda.max_memory_allocated() - base) / 1e6})
        if first is not None:
            first["after"] = (first["node"].k_pool.clone(), first["node"].v_pool.clone())
            kept.append(first)
        return out

    layout.tier_tick = timed
    return records, kept


def check_tier_passes(kept: list[dict], rounding: str) -> list[dict]:
    """Redo each kept tier pass on copies of its layer's pools (the pool
    shape, data, masks and keeps the serving path gave it), once through the
    quantize kernel and once through its plain version.  The kernel's copy
    must equal what the pass left in the engine's pools (changed where it
    demoted, untouched where it only measured), and the plain version's
    copy must equal it bit for bit with the same two residuals."""
    out = []
    for r in kept:
        dev = r["before"][0].device
        demote = torch.from_numpy(r["demote"]).to(dev)
        shadow = torch.from_numpy(r["shadow"]).to(dev)
        runs = {}
        for label, quantize in (("kernel", quantize_mantissa_op), ("plain", quantize_mantissa_plain)):
            node = dataclasses.replace(r["node"], k_pool=r["before"][0].clone(),
                                       v_pool=r["before"][1].clone())
            errs = tier_node([node], demote, shadow, *r["keeps"], rounding, quantize=quantize)
            runs[label] = (node, [float(e) for e in errs])

        def words(x):
            return x.view(torch.int16)

        kern, plain = runs["kernel"][0], runs["plain"][0]
        for name, after in zip(("k_pool", "v_pool"), r["after"]):
            check(torch.equal(words(getattr(kern, name)), words(after)),
                  f"tier pass keeps={r['keeps']}: the kernel's {name} differs from the engine's")
            check(torch.equal(words(getattr(plain, name)), words(getattr(kern, name))),
                  f"tier pass keeps={r['keeps']}: {name} through the plain version differs")
        check(runs["plain"][1] == runs["kernel"][1],
              f"tier pass keeps={r['keeps']}: residuals {runs['kernel'][1]} (kernel) != "
              f"{runs['plain'][1]} (plain)")
        changed = sum(int((words(a) != words(b)).sum()) for a, b in zip(r["before"], r["after"]))
        check((changed > 0) == bool(r["keeps"][0] is not None and r["demote"].any()),
              f"tier pass keeps={r['keeps']} changed {changed} words of the layer's pools")
        out.append({"keep": r["keeps"][0], "next_keep": r["keeps"][1],
                    "pool_shape": list(r["before"][0].shape), "rounding": rounding,
                    "pages_demoted": int(r["demote"].sum()), "pages_measured": int(r["shadow"].sum()),
                    "words_changed": changed, "err": runs["kernel"][1][0],
                    "err_down": runs["kernel"][1][1], "plain_bit_equal": True})
    return out


class StepTimer:
    """Stands in for an engine's compiled decode step while it serves: CUDA
    events around every replay (the first call, which captures, is not
    timed), with the rows active and the distinct pool pages the tables map
    at that step; and ``torch.profiler`` around the first ``profile_steps``
    replays with every row active (none at 0).  Every other attribute is the
    step's."""

    def __init__(self, eng, profile_steps: int = 3):
        self.eng = weakref.proxy(eng)  # no cycle: the engine holds the timer
        self.step = eng._step_graph
        self.records: list[tuple] = []
        self.profile_steps = profile_steps
        self.prof = None
        self.profiled = 0

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self):
        if self.step.graph is None:
            return self.step()
        from torch.profiler import ProfilerActivity, profile

        eng = self.eng
        active = int(eng._active.sum())
        groups = getattr(eng.layout, "groups", None)
        pages = (None if groups is None else
                 sum(len(np.unique(g.pool.tbl[g.pool.tbl >= 0])) for g in groups))
        if active == eng.slots and self.prof is None and self.profile_steps:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step()
        end.record()
        self.records.append((start, end, active, pages))
        if self.prof is not None and self.profiled < self.profile_steps:
            self.profiled += 1
            if self.profiled == self.profile_steps:
                end.synchronize()
                self.prof.stop()
        return out

    def summary(self) -> dict:
        """Replay times (ms, CUDA events) over the steps with every row
        active, and the profiled steps' device time and top kernels (the
        copies between host and device that the engine makes between steps
        left out; the step's own device-to-device copies kept)."""
        torch.cuda.synchronize()
        if self.prof is not None and self.profiled < self.profile_steps:
            self.prof.stop()  # the run ended first: no profile
        full = [(s.elapsed_time(e), pages) for s, e, active, pages in self.records
                if active == self.eng.slots]
        ms = [t for t, _ in full]
        out = {"steps_timed": len(self.records), "steps_all_rows_active": len(full),
               "replay_ms_median": statistics.median(ms) if ms else None,
               "replay_ms_min": min(ms, default=None), "replay_ms_max": max(ms, default=None),
               "replay_ms_median_all_steps": statistics.median(
                   s.elapsed_time(e) for s, e, _, _ in self.records) if self.records else None,
               "distinct_pages_mapped_median": (statistics.median(p for _, p in full)
                                                if full and full[0][1] is not None else None)}
        if self.profile_steps and self.profiled == self.profile_steps:
            events = [e for e in self.prof.key_averages()
                      if getattr(e, "device_time_total", 0) > 0
                      and not e.key.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
            top = sorted(events, key=lambda e: -e.device_time_total)[:6]
            out["kernel_ms_per_step"] = sum(e.device_time_total for e in events) / self.profiled / 1e3
            out["top_device_kernels"] = [
                {"name": e.key[:60], "calls_per_step": e.count / self.profiled,
                 "device_ms_per_step": e.device_time_total / self.profiled / 1e3} for e in top]
        return out


def paged_run(model, params, cfg: ServeConfig, reqs: list[Request], eager_run: bool = False,
              tier_records: bool = False, time_steps: bool = False):
    """Serve ``reqs`` step by step, captured or eager, with the launch counts
    zeroed just before and read just after.  Checks that every request
    completed within its budget, that the capture count after every decode
    step is 1 (0 eagerly) — page-table pushes, copy-on-write copies, parking
    and tier passes capture nothing — and that no tensor of the state moved
    (pools and tables are written in place, never rebound).
    ``time_steps``: the decode step runs under a :class:`StepTimer`.
    Returns (engine, outputs, counts, s, (tier timing records, kept tier
    passes) or None)."""
    eng = ServeEngine(model, params, config=cfg)
    time_prefills(eng)
    tiers = time_tier_passes(eng) if tier_records else None
    if time_steps:
        eng._step_graph = StepTimer(eng)
    ptrs = [x.data_ptr() for x in state_leaves(eng.state)]
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    captures = set()
    t0 = time.perf_counter()
    with eager() if eager_run else contextlib.nullcontext():
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        while eng.scheduler.has_work():
            eng.step()
            if eng.metrics.decode_steps:
                captures.add(eng.graph_capture_count)
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    for r in reqs:
        check(len(outs.get(r.rid, ())) == eng.scheduler.tickets[r.rid].budget,
              f"request {r.rid} incomplete")
        check(all(0 <= t < model.cfg.vocab for t in outs[r.rid]), f"request {r.rid}: token range")
    check(captures == {0 if eager_run else 1},
          f"capture counts {sorted(captures)} across the run (eager={eager_run})")
    check([x.data_ptr() for x in state_leaves(eng.state)] == ptrs,
          "a tensor of the paged state was rebound")
    return eng, outs, counts, wall, tiers


def pages_summary(eng) -> dict:
    p = eng.metrics.summary()["pages"]
    return {"pages_total": p["pages_total"],
            "pages_peak": round(p["occupancy_peak"] * p["pages_total"]),
            "pages_at_end": p["pages_used"], "shared_hits": p["shared_hits"],
            "cow_copies": p["cow_copies"], "index_evictions": p["index_evictions"],
            "page_evictions": p["page_evictions"], "dense_equiv_slots": p["dense_equiv_slots"],
            "tier_ticks": p["tier_ticks"], "tier_demoted": p["tier_demoted"],
            "tier_err_max": p["tier_err_max"], "tier_mix": p["tier_mix"]}


def phase_serve_paged(params_cache):
    """The paged KV cache at full width and depth (M16, ``impl="pallas"``,
    bf16 KV, captured steps): (a) 16 requests over a shared prefix, paged
    against dense (tokens equal request by request, captured equal to
    eager, prefix hits), with pages in use, pool bytes and every decode
    step's replay time in the run itself, paged against dense; (b) the same
    traffic on a pool cut until page pressure parks rows (tokens equal the
    dense run); (c) open-loop precision tiers, whose passes launch the
    quantize kernel (device span, kernel time and peak memory of each
    pass), one pass at each keep redone through the kernel's plain version,
    and tokens equal to an eager tiered run's;
    (d) speculative rounds whose verify appends wrap into the shared prompt
    pages (copy-on-write forks; tokens equal the dense speculative run);
    (e) adaptive serving, whose captured probe reads the pools without
    writing them (tokens and mode timeline equal the dense run's)."""
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    model = full_width_model(policy)
    params = params_cache(model)
    build.library()  # run alone, the phase's first prefill would pay the build
    reqs = prefix_traffic(model.cfg.vocab, seed=5)
    base = dict(batch_slots=8, max_len=512)
    paged = CacheConfig(layout="paged", page_size=16)
    runs = {}
    for label, cfg, eager_run in (
            ("paged", ServeConfig(cache=paged, **base), False),
            ("dense", ServeConfig(**base), False),
            ("paged_eager", ServeConfig(cache=paged, **base), True)):
        runs[label] = paged_run(model, params, cfg, reqs, eager_run=eager_run,
                                time_steps=not eager_run)
    eng, outs, counts, wall, _ = runs["paged"]
    check_same_tokens(outs, runs["dense"][1], "serve_paged (a) paged against dense")
    check_same_tokens(runs["paged_eager"][1], outs, "serve_paged (a) eager against captured")
    pages = pages_summary(eng)
    check(pages["shared_hits"] > 0, "no prefix hit")
    pool_bytes = sum(x.numel() * x.element_size() for x in pool_tensors(eng.state))
    dense_eng = runs["dense"][0]
    cache_bytes = sum(x.numel() * x.element_size() for layers in dense_eng.state.caches.values()
                      for n in layers for x in (n.k, n.v))
    # what a step's merge and copy-back move: the leaves with a batch axis
    copy_back = {label: sum(x.numel() * x.element_size()
                            for x in batch_leaves(runs[label][0]._axes, runs[label][0].state))
                 for label in ("paged", "dense")}
    # every decode step's replay in the runs themselves, tables live
    live = {label: runs[label][0]._step_graph.summary() for label in ("paged", "dense")}
    for label, t in live.items():
        check(t["steps_all_rows_active"] > 0 and "kernel_ms_per_step" in t,
              f"serve_paged (a) {label}: no step ran with every row active")
    # live tables: beyond the two shared prefix pages, every row maps its own
    check(live["paged"]["distinct_pages_mapped_median"] >= 8 + 2,
          f"serve_paged (a): the timed steps map {live['paged']['distinct_pages_mapped_median']} "
          "distinct pages")

    # (b) page pressure: max_len 96 lets the pool fall below 32 pages (one
    # row of cap 512); 18 pages of 16 hold about 3 of these rows
    base96 = dict(batch_slots=8, max_len=96)
    tight = CacheConfig(layout="paged", page_size=16, pool_pages=18)
    p_eng, p_outs, p_counts, p_wall, _ = paged_run(model, params, ServeConfig(cache=tight, **base96), reqs)
    d96 = paged_run(model, params, ServeConfig(**base96), reqs)
    check_same_tokens(p_outs, d96[1], "serve_paged (b) under page pressure against dense")
    pressure = pages_summary(p_eng)
    check(pressure["page_evictions"] >= 1, "no row was parked under page pressure")

    # (c) precision-tiered pages, open loop: cold pages demoted to 5, then 3
    # kept mantissa bits by the quantize kernel between replays
    tiers = CacheConfig(layout="paged", page_size=16, tier_policy=PageTierPolicy(
        levels=(5, 3), cold_after=16, every=4))
    t_eng, t_outs, t_counts, t_wall, (tier_passes, kept) = paged_run(
        model, params, ServeConfig(cache=tiers, **base), reqs, tier_records=True)
    t_eager = paged_run(model, params, ServeConfig(cache=tiers, **base), reqs, eager_run=True)
    check_same_tokens(t_eager[1], t_outs, "serve_paged (c) tiered eager against captured")
    tiered = pages_summary(t_eng)
    check(tiered["tier_demoted"] >= 1, "no page was demoted")
    check(pages_summary(t_eager[0])["tier_demoted"] == tiered["tier_demoted"],
          "serve_paged (c): the eager run demoted other pages")
    check(t_counts["quantize_mantissa"] > 0, "the tier passes launched the quantize kernel no time")
    tier_checks = check_tier_passes(kept, tiers.tier_policy.rounding)
    # open loop walks to the deepest tier before the first page turns cold,
    # so every pass runs at keep 3; keep 5 is held at this pool's shape in
    # check_kernels
    check(any(c["pages_demoted"] and c["keep"] for c in tier_checks),
          f"no demoting tier pass held against the plain version: "
          f"{[(c['keep'], c['next_keep']) for c in tier_checks]}")

    # (d) speculation: at max_len 64 budgets run rows to the capacity, where
    # a round's k+1 verify appends wrap onto the shared prompt pages
    spec = dict(batch_slots=8, max_len=64, spec=SpecConfig(k=3, draft_shift=1))
    s_eng, s_outs, s_counts, s_wall, _ = paged_run(model, params, ServeConfig(cache=paged, **spec), reqs)
    s_dense = paged_run(model, params, ServeConfig(**spec), reqs)
    check_same_tokens(s_outs, s_dense[1], "serve_paged (d) speculative paged against dense")
    spec_pages = pages_summary(s_eng)
    check(spec_pages["cow_copies"] > 0, "serve_paged (d): no copy-on-write fork ran")
    acceptance = s_eng.metrics.summary()["acceptance_rate"]
    check(acceptance is not None and acceptance > 0, f"serve_paged (d): acceptance {acceptance}")

    # (e) adaptation: the captured probe over the pools, one forced shift
    adapt = dict(batch_slots=8, max_len=64,
                 adapt=AdaptConfig(slo=SLO(max_err=0.05), adapt_every=2))
    a_eng, a_outs, a_counts, a_wall, a_captures = adapt_run(
        model, params, ServeConfig(cache=paged, **adapt), reqs, eager_run=False)
    a_dense = adapt_run(model, params, ServeConfig(**adapt), reqs, eager_run=False)
    check_same_tokens(a_outs, a_dense[1], "serve_paged (e) adaptive paged against dense")
    check(a_eng.metrics.mode_timeline == a_dense[0].metrics.mode_timeline,
          "serve_paged (e): the paged and dense mode timelines differ")
    check(len(a_eng.controller.history) > 0, "serve_paged (e): no probe ran")
    check(a_captures == {2} and a_eng.graph_capture_count == 2,
          f"serve_paged (e): capture counts {sorted(a_captures)} (want only 2)")
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1 with paged serving")

    # the kernels line counts the paged runs' launches (a-e; captured)
    total = {k: counts[k] + p_counts[k] + t_counts[k] + s_counts[k] + a_counts[k] for k in counts}
    tier_pool_bytes = sum(x.numel() * x.element_size() for x in pool_tensors(t_eng.state))
    emit("serve_paged", arch=ARCH, layers=model.cfg.n_layers, policy=policy.describe(),
         slots=8, max_len=512, page_size=16, requests=len(reqs),
         tokens_equal_dense=True, captured_tokens_equal_eager=True,
         build_count=build.BUILD_COUNT, graph_capture_count=eng.graph_capture_count,
         pool_bytes=pool_bytes, dense_cache_bytes=cache_bytes, pages=pages,
         copy_back_bytes_per_step=copy_back, replay_live=live,
         replay_ratio=live["paged"]["replay_ms_median"] / live["dense"]["replay_ms_median"],
         launches_paged=counts, paged=serve_summary(eng, outs, wall),
         dense=serve_summary(dense_eng, runs["dense"][1], runs["dense"][3]),
         paged_eager=serve_summary(runs["paged_eager"][0], runs["paged_eager"][1],
                                   runs["paged_eager"][3]),
         pressure={"max_len": 96, "pool_pages": 18, "pages": pressure,
                   "tokens_equal_dense": True, "launches": p_counts,
                   **serve_summary(p_eng, p_outs, p_wall)},
         tiers={"levels": [5, 3], "cold_after": 16, "every": 4, "pages": tiered,
                "pool_bytes": tier_pool_bytes, "launches": t_counts,
                "passes": tier_passes, "held_against_plain": tier_checks,
                "captured_tokens_equal_eager": True,
                **serve_summary(t_eng, t_outs, t_wall)},
         spec={"max_len": 64, "k": 3, "draft_shift": 1, "pages": spec_pages,
               "acceptance": acceptance, "tokens_equal_dense": True, "launches": s_counts,
               **serve_summary(s_eng, s_outs, s_wall)},
         adapt={"max_len": 64, "probes": len(a_eng.controller.history),
                "mode_switches": a_eng.mode_table.switches,
                "mode_timeline": [[int(st), lab] for st, lab in a_eng.metrics.mode_timeline],
                "pages": pages_summary(a_eng), "tokens_equal_dense": True,
                "timeline_equal_dense": True, "launches": a_counts,
                **serve_summary(a_eng, a_outs, a_wall)})
    return total


# ---------------------------------------------------------------------------
# per-tenant adaptation, the conditioned workload, tracing
# ---------------------------------------------------------------------------


#: the launcher's canned tenant mix (``launch/serve.py --multi-tenant``), with
#: a tight and a loose accuracy budget under one SLO
TENANT_SLO = 0.05
TENANTS = (Tenant("interactive", priority=0, share=2.0, accuracy=1e-3),
           Tenant("bulk", priority=2, share=1.0, accuracy=0.25))
#: the launcher's classes at ``--prompt-len 12 --max-new 16``
TENANT_CLASSES = (RequestClass("chat", slo_steps=10, prompt_len=6, max_new=8),
                  RequestClass("batch", prompt_len=12, max_new=16))
#: the conditioned workload's SLO at width 384: above the tame traffic's M8
#: probe residuals and below the hot batch's (0.02-0.22 and 0.42-0.47 with
#: the plain versions on the CPU, on the same weights)
COND_SLO = 0.3
COND_WIDTH = 384


def tenant_traffic(vocab: int, seed: int, n: int = 8) -> list[Request]:
    """The launcher's ``--multi-tenant`` mix: ``n/2`` bulk/batch requests,
    then ``n/2`` interactive/chat ones."""
    interactive, bulk = TENANTS
    chat, batch = TENANT_CLASSES
    rng = np.random.default_rng(seed)
    reqs = class_requests(batch, bulk, n // 2, vocab, rng)
    return reqs + class_requests(chat, interactive, n - n // 2, vocab, rng, rid_base=100)


def bound_max(eng) -> list[int]:
    """The per-site maximum over the tables of the tenants with active
    slots (every table when none has), in the step view's site order:
    what the modal step must have bound."""
    active = eng._tenant_active() or eng.tenant_tables
    return [max(int(eng.tenant_tables[n].modes()[site]) for n in active)
            for site in eng._step_modes.sites]


def tenants_run(model, params, cfg: ServeConfig, reqs: list[Request], eager_run: bool,
                force: str | None = None, time_steps: bool = False):
    """Serve ``reqs`` on a per-tenant adaptive engine step by step, captured
    or eager, with the launch counts zeroed just before.  Every decode step
    must bind, in the modal step's device view, the per-site maximum over
    the tables of the tenants active at that step (read back from the card
    after the step).  Every tick is timed (host wall; it ends in one sync a
    tenant) with the tenants it probed.  ``force``: after the third decode
    step that tenant's table is shifted one rung (down, or up at the
    bottom); no other table or controller may move with it.  Returns
    (engine, outputs, counts, s, capture counts seen after each step once a
    probe had run, tick records, the forced shift)."""
    eng = ServeEngine(model, params, config=cfg)
    time_prefills(eng)
    if time_steps:
        eng._step_graph = StepTimer(eng, profile_steps=0)
    tick, decode = eng._adapt_tick_tenants, eng._decode_step
    ticks: list[dict] = []

    def timed_tick():
        names = sorted(n for n in eng._tenant_active() if n in eng.tenant_tables)
        t0 = time.perf_counter()
        tick()
        ticks.append({"step": eng.metrics.decode_steps, "tenants": names,
                      "ms": (time.perf_counter() - t0) * 1e3})

    def checked_decode():
        want = bound_max(eng)
        events = decode()
        got = eng._step_modes._buf.tolist()  # the view this step read
        check(got == want, f"step {eng.metrics.decode_steps} bound {got}, tables say {want}")
        return events

    eng._adapt_tick_tenants, eng._decode_step = timed_tick, checked_decode
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    captures, forced = set(), None
    t0 = time.perf_counter()
    with eager() if eager_run else contextlib.nullcontext():
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        while eng.scheduler.has_work():
            eng.step()
            if any(c.history for c in eng.tenant_ctrl.values()):
                captures.add(eng.graph_capture_count)  # both steps have run
            if force and forced is None and eng.metrics.decode_steps >= 3:
                others = {n: (eng.tenant_tables[n].modes(), len(eng.tenant_ctrl[n].history))
                          for n in eng.tenant_tables if n != force}
                table = eng.tenant_tables[force]
                check(table.shift_all(1 if table.at_min else -1, tag="forced"),
                      f"the forced shift did not move {force}'s table")
                check(all((eng.tenant_tables[n].modes(), len(eng.tenant_ctrl[n].history)) == o
                          for n, o in others.items()), "a forced shift moved another tenant")
                forced = {"step": eng.metrics.decode_steps, "tenant": force,
                          "label": table.label()}
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if force:
        check(forced is not None, "the run ended before the forced shift")
        for n, t in eng.tenant_tables.items():
            check(n == force or all(tag != "forced" for tag, _ in t.history),
                  f"tenant {n}'s table took the forced shift")
    return eng, outs, build.launch_counts(), wall, captures, ticks, forced


def tenant_record(eng) -> dict:
    """Per tenant: its table's history (tag, label), its controller's
    decisions (step, decision) and residuals, and its probe count."""
    return {n: {"table": [[str(tag), "/".join(sorted({m.name for m in modes.values()}))]
                          for tag, modes in eng.tenant_tables[n].history],
                "decisions": [[o.step, o.decision] for o in eng.tenant_ctrl[n].history],
                "errs": [o.err for o in eng.tenant_ctrl[n].history],
                "probes": len(eng.tenant_ctrl[n].history),
                "final": eng.tenant_tables[n].label()}
            for n in sorted(eng.tenant_tables)}


def tick_summary(ticks: list[dict]) -> dict:
    by_n: dict[int, list[float]] = {}
    for t in ticks:
        by_n.setdefault(len(t["tenants"]), []).append(t["ms"])
    return {f"{n}_tenants": {"ticks": len(v), "ms_median": statistics.median(v),
                             "ms_min": min(v), "ms_max": max(v)}
            for n, v in sorted(by_n.items())}


def conditioned_part() -> dict:
    """The conditioned hot/cold workload (``conditioned_model``) at width
    384, M8 ``impl="pallas"`` (bound sites take the mode-map kernel):
    normal, hot, normal traffic through a single-table engine (up within
    ``cooldown + 2 * adapt_every`` decode steps of the hot batch joining,
    back to M8 after); a hot tenant beside a cold one (hot shifts up, cold
    never leaves M8); and at width 1024, monitor mode, whether the hot
    residual still clears the SLO (reported, not required)."""
    out = {}
    wl = conditioned_model(width=COND_WIDTH)
    model = wl.model.with_policy(PrecisionPolicy(default=Mode.M8, impl="pallas"))
    slo = SLO(max_err=COND_SLO)
    cfg = ServeConfig(batch_slots=4, max_len=48, adapt=AdaptConfig(slo=slo, adapt_every=2))
    eng = ServeEngine(model, wl.params, config=cfg)
    rng = np.random.default_rng(0)
    build.reset_launch_counts()
    phases = []
    for base, hot, max_new in ((0, set(), 8), (100, {0, 1, 2}, 12), (200, set(), 8)):
        at_join, up_before = eng.metrics.decode_steps, eng.controller.up_shifts
        for r in wl.requests(4, hot=hot, rng=rng, max_new=max_new):
            eng.submit(dataclasses.replace(r, rid=r.rid + base))
        up_at = None
        while eng.scheduler.has_work():
            eng.step()
            if up_at is None and eng.controller.up_shifts > up_before:
                up_at = eng.metrics.decode_steps
        phases.append({"joined_at_step": at_join, "up_at_step": up_at,
                       "label_at_end": eng.mode_table.label()})
    counts = build.launch_counts()
    window = eng.controller.cooldown + 2 * eng.adapt_every
    check(phases[0]["up_at_step"] is None and phases[0]["label_at_end"] == "M8",
          f"conditioned: tame traffic left M8 ({phases[0]})")
    check(phases[1]["up_at_step"] is not None
          and phases[1]["up_at_step"] - phases[1]["joined_at_step"] <= window,
          f"conditioned: the hot batch did not shift up within {window} steps ({phases[1]})")
    check(phases[2]["label_at_end"] == "M8" and eng.controller.down_shifts >= 1,
          f"conditioned: not back at M8 after the hot batch ({phases[2]})")
    check(counts["tile_matmul"] > 0, "conditioned: the mode-map kernel was launched no time")
    hist = eng.controller.history
    out["single_table"] = {
        "width": COND_WIDTH, "slo": COND_SLO, "adapt_every": 2, "phases": phases,
        "window_limit": window, "timeline": [[int(s), lab] for s, lab in eng.metrics.mode_timeline],
        "probes": [[o.step, o.err, o.err_down, o.decision] for o in hist],
        "launches": counts, "graph_captures": eng.graph_capture_count}

    # a hot tenant beside a cold one, their requests interleaved
    cfg = ServeConfig(batch_slots=4, max_len=48, adapt=AdaptConfig(slo=slo, adapt_every=2),
                      scheduling=SchedulingConfig(tenants=[Tenant("hot"), Tenant("cold")]))
    eng = ServeEngine(model, wl.params, config=cfg)
    rng = np.random.default_rng(1)
    hot = wl.requests(4, hot={0, 1, 2, 3}, rng=rng, max_new=12)
    cold = wl.requests(4, hot=set(), rng=rng, max_new=12)
    for h, c in zip(hot, cold):
        eng.submit(dataclasses.replace(h, tenant="hot"))
        eng.submit(dataclasses.replace(c, rid=c.rid + 100, tenant="cold"))
    cold_labels = set()
    while eng.scheduler.has_work():
        eng.step()
        cold_labels.add(eng.tenant_tables["cold"].label())
    check(eng.tenant_ctrl["hot"].up_shifts >= 1
          and int(Mode[eng.tenant_tables["hot"].label()]) > int(Mode.M8),
          "conditioned: the hot tenant did not shift up")
    check(cold_labels == {"M8"} and eng.tenant_ctrl["cold"].up_shifts == 0,
          f"conditioned: the cold tenant left M8 ({sorted(cold_labels)})")
    check(eng.graph_capture_count == 2, f"conditioned: {eng.graph_capture_count} captures")
    out["hot_beside_cold"] = {**tenant_record(eng),
                              "timeline": [[int(s), lab] for s, lab in eng.metrics.mode_timeline]}

    # width 1024 (qwen's own d_model), monitor mode: reported only
    wl = conditioned_model(width=1024)
    model = wl.model.with_policy(PrecisionPolicy(default=Mode.M8, impl="pallas"))
    eng = ServeEngine(model, wl.params, config=ServeConfig(
        batch_slots=4, max_len=48, adapt=AdaptConfig(slo=slo, adapt_every=2, adapt=False)))
    rng = np.random.default_rng(0)
    errs = {}
    for base, hot, max_new, label in ((0, set(), 8, "tame"), (100, {0, 1, 2}, 12, "hot"),
                                      (200, set(), 8, "tame_after")):
        n0 = len(eng.controller.history)
        for r in wl.requests(4, hot=hot, rng=rng, max_new=max_new):
            eng.submit(dataclasses.replace(r, rid=r.rid + base))
        eng.drain()
        errs[label] = [o.err for o in eng.controller.history[n0:]]
    out["width_1024"] = {
        "slo": COND_SLO, "errs": errs,
        "hot_max": max(errs["hot"]), "tame_max": max(errs["tame"] + errs["tame_after"]),
        "hot_clears_slo": max(errs["hot"]) > COND_SLO,
        "tame_under_slo": max(errs["tame"] + errs["tame_after"]) < COND_SLO}
    return out


def release() -> None:
    """Free the engines that are gone: the monkeypatched hooks of a phase
    hold their engine in a reference cycle, and each captured engine keeps
    its graphs' private memory pools (several GB at full depth) until the
    cycle is collected."""
    gc.collect()
    torch.cuda.empty_cache()


def traced_summary(eng, trace_path: str) -> dict:
    """Export a traced engine's Chrome trace and hold it to the port's own
    checks: schema and span tree, request lifecycles, a lossless ring, no
    recompile, a non-empty Prometheus exposition."""
    doc = eng.tracer.export_chrome(trace_path)
    events = list(eng.tracer.events)
    problems = validate_chrome(doc) + span_violations(events)
    check(not problems, f"serve_tenants trace: {problems[:5]}")
    check(eng.tracer.dropped == 0, f"{eng.tracer.dropped} trace events dropped")
    check(eng.profiler.recompiles == 0, f"{eng.profiler.recompiles} recompiles")
    prom = eng.tracer.prometheus()
    check(bool(prom.strip()), "empty Prometheus exposition")
    kinds: dict[str, int] = {}
    for e in events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    return {"chrome_events": len(doc["traceEvents"]), "trace_events": eng.tracer.emitted,
            "kinds": kinds,
            "mode_switch_tenants": sorted({(e.data or {}).get("tenant") for e in events
                                           if e.kind == "mode_switch"} - {None}),
            "recompiles": eng.profiler.recompiles, "profile": eng.profiler.snapshot(),
            "prometheus_lines": len(prom.splitlines()),
            "timeline_rows": len(eng.tracer.precision_timeline()),
            "trace_path": os.path.relpath(trace_path, _ROOT)}


def phase_serve_tenants(params_cache):
    """Per-tenant adaptation at full width and depth (M24 ``impl="pallas"``,
    4 slots, ``adapt_every`` 2): the launcher's interactive/bulk mix with a
    tight and a loose budget, captured and eager — equal tokens, per-tenant
    timelines and controller decisions; one build; two captures (decode
    step, probe) whatever mix is active; the bound view at the per-site
    maximum after every step; one forced shift of the bulk table that the
    interactive tenant does not feel; probes per tenant equal to its ticks
    with active slots.  Then the conditioned workload (``conditioned_part``)
    and the per-tenant run traced (``TraceConfig``, the trace written under
    ``build/``) twice, between two more untraced runs: tokens and launches
    per replay equal the untraced run's, a valid Chrome trace, no lifecycle
    violation, no recompile, and the walls of both arms.  Each engine is
    released before the next is made."""
    release()
    policy = PrecisionPolicy(default=Mode.M24, impl="pallas")
    model = full_width_model(policy)
    params = params_cache(model)
    build.library()
    reqs = tenant_traffic(model.cfg.vocab, seed=6)
    cfg = ServeConfig(batch_slots=4, max_len=48,
                      scheduling=SchedulingConfig(tenants=list(TENANTS),
                                                  classes=list(TENANT_CLASSES)),
                      adapt=AdaptConfig(slo=SLO(max_err=TENANT_SLO), adapt_every=2))
    eng, outs, counts, wall, captures, ticks, forced = tenants_run(
        model, params, cfg, reqs, False, force="bulk", time_steps=True)
    record = tenant_record(eng)
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1 under per-tenant tables")
    check(captures == {2} and eng.graph_capture_count == 2,
          f"serve_tenants: capture counts {sorted(captures)} (want only 2)")
    check(counts["tile_matmul"] > 0, "serve_tenants launched the mode-map kernel no time")
    check_decode_attention_replays(eng, "serve_tenants")
    probed = {n: sum(n in t["tenants"] for t in ticks) for n in eng.tenant_tables}
    check(probed == {n: record[n]["probes"] for n in record},
          f"serve_tenants: probes {({n: r['probes'] for n, r in record.items()})} "
          f"against ticks with active slots {probed}")
    check(min(probed["interactive"], probed["bulk"]) > 0, "a tenant was never probed")
    check(any(len(t["tenants"]) == 2 for t in ticks), "no tick probed both tenants")
    launches_per_replay = {g: getattr(eng, g).launches for g in ("_step_graph", "_probe_graph")}
    main = dict(graph_capture_counts_seen=sorted(captures), forced=forced, per_tenant=record,
                bound_timeline=[[int(s), lab] for s, lab in eng.metrics.mode_timeline],
                adaptation=eng.describe_adaptation().splitlines(),
                replay=eng._step_graph.summary(), ticks=tick_summary(ticks), tick_records=ticks,
                **serve_summary(eng, outs, wall))
    timeline = eng.metrics.mode_timeline
    del eng
    release()

    e_eng, e_outs, _, e_wall, e_captures, e_ticks, _ = tenants_run(
        model, params, cfg, reqs, True, force="bulk")
    check_same_tokens(e_outs, outs, "serve_tenants eager against captured")
    e_record = tenant_record(e_eng)
    for n in record:
        check(record[n]["table"] == e_record[n]["table"],
              f"serve_tenants: tenant {n}'s mode timeline differs captured / eager")
        check(record[n]["decisions"] == e_record[n]["decisions"],
              f"serve_tenants: tenant {n}'s controller decisions differ captured / eager")
    check(e_eng.metrics.mode_timeline == timeline,
          "serve_tenants: the bound mode timelines differ captured / eager")
    check(e_captures == {0}, f"serve_tenants: the eager run captured {sorted(e_captures)}")
    err_gap = max((abs(a - b) for n in record
                   for a, b in zip(record[n]["errs"], e_record[n]["errs"])), default=0.0)
    eager = dict(eager_ticks=tick_summary(e_ticks), eager=serve_summary(e_eng, e_outs, e_wall))
    del e_eng
    release()

    cond = conditioned_part()
    release()

    # (c) the per-tenant run traced against untraced, captured, in the
    # order traced / untraced / untraced / traced (host walls spread from
    # run to run by more than tracing costs); each against the main run
    trace_path = os.path.join(_ROOT, "build", "serve_tenants_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    t_cfg = dataclasses.replace(cfg, trace=TraceConfig(out=trace_path))
    walls = {"traced": [], "untraced": []}
    for label in ("traced", "untraced", "untraced", "traced"):
        t_eng, t_outs, t_counts, t_wall, _, _, _ = tenants_run(
            model, params, t_cfg if label == "traced" else cfg, reqs, False, force="bulk")
        check_same_tokens(t_outs, outs, f"serve_tenants {label} against the main run")
        check(t_counts == counts, f"serve_tenants: {label} launches {t_counts} != {counts}")
        for g, want in launches_per_replay.items():
            check(getattr(t_eng, g).launches == want,
                  f"serve_tenants: a {label} {g} replay launches other kernels")
        walls[label].append(t_wall)
        if label == "traced":
            traced = traced_summary(t_eng, trace_path)
        del t_eng
        release()
    emit("serve_tenants", arch=ARCH, layers=model.cfg.n_layers, policy=policy.describe(),
         slots=4, adapt_every=2, slo=TENANT_SLO,
         tenants={t.name: {"priority": t.priority, "share": t.share, "accuracy": t.accuracy}
                  for t in TENANTS},
         launches=counts, build_count=build.BUILD_COUNT, captured_tokens_equal_eager=True,
         probe_err_gap_captured_eager=err_gap, **main, **eager, conditioned=cond,
         traced={"tokens_equal_untraced": True, "launches_per_replay_equal": True,
                 "walls_s": walls, "wall_ratio_of_medians": (
                     statistics.median(walls["traced"]) / statistics.median(walls["untraced"])),
                 **traced})
    return counts


# ---------------------------------------------------------------------------
# the recurrent families: Mamba-2 (ssm) and RecurrentGemma (hybrid)
# ---------------------------------------------------------------------------


def served(model, params, config: ServeConfig, reqs: list[Request],
           eager_run: bool = False) -> dict:
    """Serve ``reqs`` on one engine through ``paged_run`` (captured, or
    eager with ``eager_run``; dense or paged as ``config`` says), read it,
    then retire it: the engine dies with its last reference, its graphs'
    pool with it (``retire`` checks and measures that)."""
    holder = {}
    holder["eng"], outs, counts, wall, _ = paged_run(model, params, config, reqs,
                                                     eager_run=eager_run)
    eng = holder["eng"]
    m = eng.metrics.summary()
    out = {"outs": outs, "counts": counts, "summary": serve_summary(eng, outs, wall),
           "captures": eng.graph_capture_count,
           "pages": pages_summary(eng) if config.cache.layout == "paged" else None,
           "acceptance": m.get("acceptance_rate"),
           "verify_steps_per_token": m.get("verify_steps_per_token")}
    del eng
    out["freed"] = retire(holder, "eng")
    return out


def param_gb(params) -> float:
    def walk(x):
        return (sum(walk(v) for v in x.values()) if isinstance(x, dict)
                else x.numel() * x.element_size())
    return walk(params) / 1e9


def prefill_vs_steps_gap(model, params, prompt: np.ndarray, max_len: int) -> float:
    """The last prompt position's logits from one multi-token prefill
    against feeding the prompt one token at a time (the chunked / scanned
    forms against the per-token recurrences), over the logits' spread."""
    toks = torch.as_tensor(np.asarray(prompt, np.int64)[None, :], device="cuda")
    full, _ = model.decode_step(params, toks, model.init_decode_state(1, max_len, per_slot=True))
    state = model.init_decode_state(1, max_len, per_slot=True)
    for i in range(toks.shape[1]):
        step, state = model.decode_step(params, toks[:, i:i + 1], state)
    check(bool(torch.isfinite(full).all()) and bool(torch.isfinite(step).all()),
          "non-finite logits")
    return float((full[0, -1] - step[0, -1]).abs().max() / full[0, -1].std())


def phase_serve_ssm(params_cache):
    """Mamba-2 2.7b at full width and depth (64 layers, d_model 2560, 80 SSD
    heads of 64, state 128) served at M16 ``pallas`` from 4 slots, 8 ragged
    requests, captured and eager: equal tokens, equal to the 1-slot solo
    decode, one capture, at most one build.  Its projections, SSD
    contractions and logits are general einsums (plain limb algebra, as in
    the reference), so none of the four kernels launches: the phase checks
    that and says so.  Beside it the decode step's breakdown (replay by
    CUDA events, kernel time, busy share, the recurrent state's copy-back
    bytes) and a prefill against the per-token recurrence."""
    release()
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    model = full_width_model(policy, arch=SSM_ARCH)
    params = params_cache(model)
    reqs = ragged_requests(8, model.cfg.vocab, 48, 16, np.random.default_rng(20))
    cfg = ServeConfig(batch_slots=4, max_len=96)
    cap = served(model, params, cfg, reqs)
    eag = served(model, params, cfg, reqs, eager_run=True)
    check_same_tokens(eag["outs"], cap["outs"], "serve_ssm eager against captured")
    for r in reqs[:2]:
        check(solo_tokens(model, params, r, 96) == cap["outs"][r.rid],
              f"serve_ssm request {r.rid}: batched tokens != solo decode")
    check(cap["captures"] == 1, f"serve_ssm captured {cap['captures']} graphs")
    check(build.BUILD_COUNT <= 1, f"build count {build.BUILD_COUNT} > 1")
    check(not any(cap["counts"].values()) and not any(eag["counts"].values()),
          f"serve_ssm launched a kernel: {cap['counts']} (its sites are general einsums)")
    check(cap["freed"]["reserved_freed_gb"] > 0, "the captured engine's pool was not freed")
    gap = prefill_vs_steps_gap(model, params, reqs[0].prompt[:32], 96)
    check(gap < 1e-3, f"serve_ssm: chunked prefill vs per-token recurrence {gap:.3e}")
    breakdown = step_breakdown(model, params)
    c = model.cfg
    emit("serve_ssm", arch=SSM_ARCH, layers=c.n_layers, d_model=c.d_model,
         d_inner=c.ssm_expand * c.d_model, ssd_heads=c.ssm_expand * c.d_model // c.ssm_head_dim,
         ssm_head_dim=c.ssm_head_dim, ssm_state=c.ssm_state, vocab=c.vocab,
         param_gb=param_gb(params), policy=policy.describe(), launches=cap["counts"],
         kernels_launched="none: every site of the family is a general einsum "
                          "(mp_einsum sends only mk,kn->mn to the kernels, as the reference's)",
         build_count=build.BUILD_COUNT, captured_tokens_equal_eager=True,
         solo_equal_rids=[r.rid for r in reqs[:2]], prefill_vs_steps_gap_over_spread=gap,
         captured=cap["summary"], eager=eag["summary"],
         freed_between_engines={"captured": cap["freed"], "eager": eag["freed"]},
         breakdown=breakdown)
    return cap["counts"]


def wrap_traffic(vocab: int, seed: int, n: int = 3) -> list[Request]:
    """``n`` requests over one shared prompt prefix of HYBRID_WRAP_PREFIX
    tokens, 8 tokens of their own each (2,040 in all, within the 2,048
    window, so the prefix pages are shared) and 40 new tokens, which carry
    every row across the window: the ring then writes back into the shared
    prompt pages."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, HYBRID_WRAP_PREFIX)
    return [Request(np.concatenate([prefix, rng.integers(0, vocab, 8)]).astype(np.int32), 40,
                    rid=i) for i in range(n)]


def phase_serve_hybrid(params_cache):
    """RecurrentGemma-9b (12 (rec, rec, attn_local) supergroups + 2
    remainder layers, d_model 4096, d_ff 12288, 16 heads of 256, MQA, vocab
    256000 untied, window 2048), in four parts:

    (a) full depth, M16 ``pallas``, 4 slots, 8 ragged requests, captured and
        eager: equal tokens, equal to the solo decode, one capture, the limb
        kernel launched (every block's MLP and the attention projections),
        the mode-map kernel not; the decode step's breakdown; the logits of
        the kernel path against the plain limb algebra;
    (b) full depth, M24 + SLO 0.05 with one forced shift: one capture each
        of the modal step and the probe across the shifts, one build, the
        mode-map kernel launched;
    (c) HYBRID_CUT_LAYERS layers: speculation (k = 3, draft shift 2)
        against the plain arm, and the paged cache (pages of 16, a shared
        32-token prefix) against the dense cache: equal tokens;
    (d) HYBRID_WRAP_LAYERS layers, 3 requests over a 2,032-token shared
        prefix + 40 new: paged == dense through the window's wrap with
        copy-on-write forks, and speculative == plain, paged and dense.

    Every engine is retired before the next is made (``retire``)."""
    release()
    out = {"depth_cuts": {"a_b": None, "c": HYBRID_CUT_LAYERS, "d": HYBRID_WRAP_LAYERS}}
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    model = full_width_model(policy, arch=HYBRID_ARCH)
    params = params_cache(model)
    out["depth_cuts"]["a_b"] = model.cfg.n_layers
    out["param_gb_full"] = param_gb(params)
    build.library()
    reqs = ragged_requests(8, model.cfg.vocab, 48, 16, np.random.default_rng(21))
    cfg = ServeConfig(batch_slots=4, max_len=96)
    # (a)
    cap = served(model, params, cfg, reqs)
    eag = served(model, params, cfg, reqs, eager_run=True)
    check_same_tokens(eag["outs"], cap["outs"], "serve_hybrid eager against captured")
    check(solo_tokens(model, params, reqs[0], 96) == cap["outs"][reqs[0].rid],
          "serve_hybrid: batched tokens != solo decode")
    check(cap["captures"] == 1, f"serve_hybrid captured {cap['captures']} graphs")
    check(cap["counts"]["limb_matmul"] > 0, "serve_hybrid launched the limb kernel no time")
    check(cap["counts"]["tile_matmul"] == 0, "a static policy reached the mode-map kernel")
    check(cap["freed"]["reserved_freed_gb"] > 0, "the captured engine's pool was not freed")
    counts = dict(cap["counts"])
    breakdown = step_breakdown(model, params, bound_logits=False)
    ref_model = model.with_policy(PrecisionPolicy(default=Mode.M16, impl="xla"))
    toks = torch.as_tensor(np.asarray(reqs[0].prompt)[None, :], device="cuda")
    l_kernel, _ = model.decode_step(params, toks, model.init_decode_state(1, 96, per_slot=True))
    l_plain, _ = ref_model.decode_step(params, toks,
                                       ref_model.init_decode_state(1, 96, per_slot=True))
    check(bool(torch.isfinite(l_kernel).all()), "non-finite logits")
    check(tuple(l_kernel.shape) == (1, len(reqs[0].prompt), model.cfg.vocab), "logits shape")
    gap = float((l_kernel - l_plain).abs().max() / l_plain.std())
    check(gap < 1e-3, f"hybrid kernel-path logits differ from the plain limb algebra: {gap:.3e}")
    del l_kernel, l_plain, ref_model
    out["a"] = dict(policy=policy.describe(), launches=cap["counts"], captured=cap["summary"],
                    eager=eag["summary"], captured_tokens_equal_eager=True,
                    solo_equal_rids=[reqs[0].rid], logits_gap_vs_plain_over_spread=gap,
                    freed_between_engines={"captured": cap["freed"], "eager": eag["freed"]},
                    breakdown=breakdown)
    del cap, eag
    release()
    # (b)
    m_policy = PrecisionPolicy(default=Mode.M24, impl="pallas")
    m_model = model.with_policy(m_policy)
    m_cfg = ServeConfig(batch_slots=4, max_len=96,
                        adapt=AdaptConfig(slo=SLO(max_err=0.05), adapt_every=2))
    holder = {}
    holder["eng"], m_outs, m_counts, m_wall, m_captures = adapt_run(
        m_model, params, m_cfg, reqs[:4], eager_run=False, time_steps=True)
    eng = holder["eng"]
    check(m_captures == {2} and eng.graph_capture_count == 2,
          f"serve_hybrid (b): capture counts {sorted(m_captures)} across shifts (want only 2)")
    check(m_counts["tile_matmul"] > 0, "serve_hybrid (b) launched the mode-map kernel no time")
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1 after mode shifts")
    out["b"] = dict(policy=m_policy.describe(), launches=m_counts,
                    graph_capture_counts_seen=sorted(m_captures),
                    mode_timeline=[[int(st), lab] for st, lab in eng.metrics.mode_timeline],
                    probes=len(eng.controller.history), replay=eng._step_graph.summary(),
                    **serve_summary(eng, m_outs, m_wall))
    for k, v in m_counts.items():
        counts[k] = counts.get(k, 0) + v
    del eng
    out["b"]["freed"] = retire(holder, "eng")
    del params, model, m_model
    release()
    # (c)
    model = full_width_model(policy, HYBRID_CUT_LAYERS, arch=HYBRID_ARCH)
    params = params_cache(model)
    plain = served(model, params, cfg, reqs)
    spec = served(model, params, dataclasses.replace(cfg, spec=SpecConfig(k=3, draft_shift=2)),
                  reqs)
    check_same_tokens(spec["outs"], plain["outs"], "serve_hybrid (c): speculative against plain")
    check(spec["acceptance"] is not None and spec["acceptance"] > 0,
          f"serve_hybrid (c): acceptance {spec['acceptance']}")
    preqs = prefix_traffic(model.cfg.vocab, seed=23, n=8)
    dense = served(model, params, cfg, preqs)
    paged = served(model, params, dataclasses.replace(
        cfg, cache=CacheConfig(layout="paged", page_size=16)), preqs)
    check_same_tokens(paged["outs"], dense["outs"], "serve_hybrid (c): paged against dense")
    check(paged["pages"]["shared_hits"] > 0, "serve_hybrid (c): no prefix hit")
    out["c"] = dict(layers=HYBRID_CUT_LAYERS, spec_tokens_equal_plain=True,
                    paged_tokens_equal_dense=True, acceptance=spec["acceptance"],
                    verify_steps_per_token=spec["verify_steps_per_token"],
                    plain=plain["summary"], spec=spec["summary"],
                    tok_per_s_ratio_spec=(spec["summary"]["tok_per_s"]
                                          / plain["summary"]["tok_per_s"]),
                    dense=dense["summary"], paged=paged["summary"], pages=paged["pages"],
                    freed=[x["freed"] for x in (plain, spec, dense, paged)])
    del params, model
    release()
    # (d)
    model = full_width_model(policy, HYBRID_WRAP_LAYERS, arch=HYBRID_ARCH)
    params = params_cache(model)
    wreqs = wrap_traffic(model.cfg.vocab, seed=24)
    window = model.cfg.local_window
    max_len = HYBRID_WRAP_PREFIX + 8 + 40 + 32
    check(all(len(r.prompt) <= window < len(r.prompt) + r.max_new for r in wreqs),
          "ring-wrap traffic does not cross the window")
    wcfg = ServeConfig(batch_slots=3, max_len=max_len)
    pcache = CacheConfig(layout="paged", page_size=16)
    k3 = SpecConfig(k=3, draft_shift=2)
    arms = {"dense": wcfg, "paged": dataclasses.replace(wcfg, cache=pcache),
            "paged_spec": dataclasses.replace(wcfg, cache=pcache, spec=k3),
            "dense_spec": dataclasses.replace(wcfg, spec=k3)}
    wrap = {name: served(model, params, c, wreqs) for name, c in arms.items()}
    for name in ("paged", "paged_spec", "dense_spec"):
        check_same_tokens(wrap[name]["outs"], wrap["dense"]["outs"],
                          f"serve_hybrid (d): {name} against dense through the wrap")
    for name in ("paged", "paged_spec"):
        check(wrap[name]["pages"]["cow_copies"] > 0,
              f"serve_hybrid (d): {name} made no copy-on-write fork across the wrap")
        check(wrap[name]["pages"]["shared_hits"] > 0, f"serve_hybrid (d): {name}: no prefix hit")
    out["d"] = dict(layers=HYBRID_WRAP_LAYERS, window=window, max_len=max_len,
                    prompt_len=[len(r.prompt) for r in wreqs], max_new=40,
                    tokens_equal_dense={n: True for n in arms if n != "dense"},
                    pages={n: wrap[n]["pages"] for n in ("paged", "paged_spec")},
                    acceptance={n: wrap[n]["acceptance"] for n in ("paged_spec", "dense_spec")},
                    summaries={n: wrap[n]["summary"] for n in arms},
                    freed={n: wrap[n]["freed"] for n in arms})
    del params, model
    release()
    c = get_config(HYBRID_ARCH)
    emit("serve_hybrid", arch=HYBRID_ARCH, layers=c.n_layers, d_model=c.d_model, d_ff=c.d_ff,
         heads=c.n_heads, kv_heads=c.n_kv_heads, head_dim=c.head_dim, vocab=c.vocab,
         window=c.local_window, launches=counts, build_count=build.BUILD_COUNT, **out)
    return counts


@contextlib.contextmanager
def moe_expert_events():
    """Every ``"moe_expert"`` einsum of ``moe_apply`` bracketed by CUDA
    events while the context is open: yields the list of (start, end) pairs
    the calls record.  The wrapper replaces the name ``pein`` in
    ``models.moe`` and calls the original unchanged; an eager step queues
    each product's kernels far ahead of the card (a split of a 1.68 GB
    weight takes milliseconds), so a pair brackets those kernels' device
    time."""
    from repro_torch.models import moe as moe_lib

    inner = moe_lib.pein
    pairs: list = []

    def pein(eq, a, b, op, policy):
        if op != "moe_expert":
            return inner(eq, a, b, op, policy)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(eq, a, b, op, policy)
        end.record()
        pairs.append((start, end))
        return out

    moe_lib.pein = pein
    try:
        yield pairs
    finally:
        moe_lib.pein = inner


def phase_serve_moe(params_cache):
    """Phi-3.5-MoE at full width (d_model 4096, 32 heads, 8 KV heads, 16
    experts of d_ff 6400, top-2, vocab 32064 untied), cut to MOE_CUT_LAYERS
    of its 32 layers, in four arms.  The rows of a MoE decode step share
    expert capacity (one slot an expert at 4 slots), so no arm holds batched
    tokens to solo ones or speculative tokens to plain ones (the reference's
    engine differs there too); each arm holds captured to eager:

    (a) M16 ``pallas``, 4 slots, 8 ragged requests (prompts <= 48, 16 new):
        equal tokens, one capture, at most one build, the limb kernel
        launched (attention projections), the engine freed at its last
        reference; the decode step's breakdown and the expert products'
        share of it, by CUDA events around those products in eager steps
        (``moe_expert_events``);
    (b) M24 + SLO 0.05 with a forced shift: equal tokens and mode
        timelines, captures {2}, one build;
    (c) speculation k = 3, draft shift 2: equal speculative tokens, the
        acceptance;
    (d) the paged cache (pages of 16, 8 requests over a shared 32-token
        prefix) against the dense one: paged captured == paged eager, and
        whether paged == dense.  Two mechanisms let them differ (ROADMAP
        Queue C): a prompt's prefill routes the whole prompt as one group,
        so a shared prefix page holds K/V that another request's suffix
        helped route; and an inactive row routes with the live ones,
        reading the scratch page in the paged layout, its frozen cache in
        the dense one."""
    release()
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    model = full_width_model(policy, MOE_CUT_LAYERS, arch=MOE_ARCH)
    params = params_cache(model)
    out = {"param_gb": param_gb(params), "layers": MOE_CUT_LAYERS,
           "depth_cut": f"{MOE_CUT_LAYERS} of {get_config(MOE_ARCH).n_layers} layers"}
    build.library()
    reqs = ragged_requests(8, model.cfg.vocab, 48, 16, np.random.default_rng(30))
    cfg = ServeConfig(batch_slots=4, max_len=96)
    # (a)
    cap = served(model, params, cfg, reqs)
    eag = served(model, params, cfg, reqs, eager_run=True)
    check_same_tokens(eag["outs"], cap["outs"], "serve_moe (a) eager against captured")
    check(cap["captures"] == 1, f"serve_moe (a) captured {cap['captures']} graphs")
    check(build.BUILD_COUNT <= 1, f"build count {build.BUILD_COUNT} > 1")
    check(cap["counts"]["limb_matmul"] > 0, "serve_moe launched the limb kernel no time")
    check(cap["counts"]["tile_matmul"] == 0, "a static policy reached the mode-map kernel")
    check(cap["freed"]["reserved_freed_gb"] > 0, "the captured engine's pool was not freed")
    counts = dict(cap["counts"])
    breakdown = step_breakdown(model, params, bound_logits=False, sites=moe_expert_events)
    expert_ms = breakdown["eager_sites"]["device_ms_per_step"]
    check(breakdown["eager_sites"]["calls_per_step"] == 3 * MOE_CUT_LAYERS,
          f"serve_moe: {breakdown['eager_sites']['calls_per_step']} expert products a step")
    moe_layers = [ly for ly in model.layers if ly.kind == "moe"]
    gate = params[moe_layers[0].top][moe_layers[0].key]["moe"]["gate"]
    moe = {"capacity_per_expert": capacity_for(4, model.cfg), "moe_layers": len(moe_layers),
           "expert_weight_gb_per_layer": 3 * gate[0].numel() * 4 / 1e9,
           "expert_products_device_ms_per_step": expert_ms,
           "expert_share_of_replay": expert_ms / breakdown["replay_event_ms"],
           "expert_share_of_eager_kernel_time":
               expert_ms / breakdown["eager"]["device_ms_per_decode_step"]}
    out["a"] = dict(policy=policy.describe(), launches=cap["counts"], captured=cap["summary"],
                    eager=eag["summary"], captured_tokens_equal_eager=True,
                    freed_between_engines={"captured": cap["freed"], "eager": eag["freed"]},
                    breakdown=breakdown, moe_experts=moe)
    del cap, eag
    release()
    # (b)
    m_policy = PrecisionPolicy(default=Mode.M24, impl="pallas")
    m_model = model.with_policy(m_policy)
    m_cfg = ServeConfig(batch_slots=4, max_len=96,
                        adapt=AdaptConfig(slo=SLO(max_err=0.05), adapt_every=2))
    holder = {}
    holder["eng"], m_outs, m_counts, m_wall, m_captures = adapt_run(
        m_model, params, m_cfg, reqs[:4], eager_run=False, time_steps=True)
    eng = holder["eng"]
    holder["eager"], e_outs, _, e_wall, e_captures = adapt_run(
        m_model, params, m_cfg, reqs[:4], eager_run=True)
    check_same_tokens(e_outs, m_outs, "serve_moe (b) eager against captured")
    check(eng.metrics.mode_timeline == holder["eager"].metrics.mode_timeline,
          "serve_moe (b): the captured and eager mode timelines differ")
    check(m_captures == {2} and eng.graph_capture_count == 2,
          f"serve_moe (b): capture counts {sorted(m_captures)} across shifts (want only 2)")
    check(e_captures == {0}, f"serve_moe (b): the eager run captured {sorted(e_captures)}")
    check(m_counts["tile_matmul"] > 0, "serve_moe (b) launched the mode-map kernel no time")
    check(build.BUILD_COUNT == 1, f"build count {build.BUILD_COUNT} != 1 after mode shifts")
    out["b"] = dict(policy=m_policy.describe(), launches=m_counts,
                    graph_capture_counts_seen=sorted(m_captures),
                    captured_tokens_equal_eager=True,
                    mode_timeline=[[int(st), lab] for st, lab in eng.metrics.mode_timeline],
                    probes=len(eng.controller.history), replay=eng._step_graph.summary(),
                    **serve_summary(eng, m_outs, m_wall),
                    eager=serve_summary(holder["eager"], e_outs, e_wall))
    for k, v in m_counts.items():
        counts[k] = counts.get(k, 0) + v
    del eng
    out["b"]["freed"] = retire(holder, "eng")
    out["b"]["freed_eager"] = retire(holder, "eager")
    del m_model
    release()
    # (c)
    spec_cfg = dataclasses.replace(cfg, spec=SpecConfig(k=3, draft_shift=2))
    spec = served(model, params, spec_cfg, reqs)
    spec_e = served(model, params, spec_cfg, reqs, eager_run=True)
    check_same_tokens(spec_e["outs"], spec["outs"],
                      "serve_moe (c) speculative eager against captured")
    check(spec["acceptance"] is not None and spec["acceptance"] > 0,
          f"serve_moe (c): acceptance {spec['acceptance']}")
    out["c"] = dict(k=3, draft_shift=2, captured_tokens_equal_eager=True,
                    acceptance=spec["acceptance"],
                    verify_steps_per_token=spec["verify_steps_per_token"],
                    captured=spec["summary"], eager=spec_e["summary"],
                    tok_per_s_ratio_to_a=(spec["summary"]["tok_per_s"]
                                          / out["a"]["captured"]["tok_per_s"]),
                    freed=[spec["freed"], spec_e["freed"]])
    for k, v in spec["counts"].items():
        counts[k] = counts.get(k, 0) + v
    release()
    # (d)
    preqs = prefix_traffic(model.cfg.vocab, seed=31, n=8)
    pcfg = dataclasses.replace(cfg, cache=CacheConfig(layout="paged", page_size=16))
    dense = served(model, params, cfg, preqs)
    paged = served(model, params, pcfg, preqs)
    paged_e = served(model, params, pcfg, preqs, eager_run=True)
    check_same_tokens(paged_e["outs"], paged["outs"], "serve_moe (d) paged eager against captured")
    check(paged["pages"]["shared_hits"] > 0, "serve_moe (d): no prefix hit")
    differ = [r.rid for r in preqs if paged["outs"][r.rid] != dense["outs"][r.rid]]
    out["d"] = dict(paged_tokens_equal_dense=not differ, rids_paged_differs_from_dense=differ,
                    paged_vs_dense_note=(
                        None if not differ else
                        "allowed: a shared prefix page holds K/V routed with another "
                        "request's suffix (a prefill routes the whole prompt as one group), "
                        "and inactive rows route with the live ones (dense: their frozen "
                        "cache, paged: the scratch page); ROADMAP Queue C, "
                        "tests/test_torch_moe_engine.py::"
                        "test_paged_and_dense_differ_only_where_the_reference_does"),
                    paged_tokens={r.rid: paged["outs"][r.rid] for r in preqs if r.rid in differ},
                    dense_tokens={r.rid: dense["outs"][r.rid] for r in preqs if r.rid in differ},
                    captured_tokens_equal_eager=True, pages=paged["pages"],
                    dense=dense["summary"], paged=paged["summary"],
                    paged_eager=paged_e["summary"])
    del params, model
    release()
    c = get_config(MOE_ARCH)
    emit("serve_moe", arch=MOE_ARCH, d_model=c.d_model, heads=c.n_heads, kv_heads=c.n_kv_heads,
         experts=c.moe_experts, top_k=c.moe_top_k, d_ff=c.d_ff, vocab=c.vocab,
         launches=counts, build_count=build.BUILD_COUNT, **out)
    return counts


def phase_serve_configs(params_cache):
    """The dense configs the port gained with the remaining families, each at
    full width (CONFIG_DEPTHS: qwen1.5-4b and phi3-mini at full depth,
    command-r+ at one layer), M16 ``pallas``, 4 slots, 4 requests of 8 new
    tokens: captured == eager tokens, one capture, the limb kernel
    launched; each engine's peak memory."""
    counts: dict = {}
    out = {}
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    for i, (arch, depth) in enumerate(CONFIG_DEPTHS.items()):
        release()
        model = full_width_model(policy, depth, arch=arch)
        params = params_cache(model)
        reqs = ragged_requests(4, model.cfg.vocab, 48, 8, np.random.default_rng(40 + i))
        reqs = [dataclasses.replace(r, max_new=8) for r in reqs]
        cfg = ServeConfig(batch_slots=4, max_len=64)
        cap = served(model, params, cfg, reqs)
        eag = served(model, params, cfg, reqs, eager_run=True)
        check_same_tokens(eag["outs"], cap["outs"], f"serve_configs {arch} eager against captured")
        check(cap["captures"] == 1, f"serve_configs {arch}: {cap['captures']} captures")
        check(cap["counts"]["limb_matmul"] > 0, f"serve_configs {arch}: no limb kernel launched")
        c = model.cfg
        out[arch] = dict(layers=c.n_layers, full_layers=get_config(arch).n_layers,
                         d_model=c.d_model, heads=c.n_heads, kv_heads=c.n_kv_heads,
                         d_ff=c.d_ff, vocab=c.vocab, param_gb=param_gb(params),
                         captured_tokens_equal_eager=True, launches=cap["counts"],
                         captured=cap["summary"], eager=eag["summary"],
                         peak_device_mem_gb=max(cap["summary"]["peak_device_mem_gb"],
                                                eag["summary"]["peak_device_mem_gb"]))
        for k, v in cap["counts"].items():
            counts[k] = counts.get(k, 0) + v
        del cap, eag, params, model
    release()
    emit("serve_configs", policy=policy.describe(), build_count=build.BUILD_COUNT,
         launches=counts, configs=out)
    return counts


def greedy_decode(model, params, prompt: torch.Tensor, n_new: int, max_len: int,
                  frames=None, pixel_embeds=None):
    """Greedy tokens through the model's entry points: ``prefill_encoder``
    (enc-dec), a prefill (with the patch embeddings, VLM), then ``n_new - 1``
    single-token ``decode_step`` calls.  Returns (tokens, every logits row
    the calls produced, concatenated)."""
    state = model.init_decode_state(prompt.shape[0], max_len, per_slot=True)
    if frames is not None:
        state = model.prefill_encoder(params, frames, state)
    logits, state = model.decode_step(params, prompt, state, pixel_embeds=pixel_embeds)
    rows, toks = [logits], [torch.argmax(logits[:, -1], dim=-1)]
    for _ in range(n_new - 1):
        logits, state = model.decode_step(params, toks[-1][:, None], state)
        rows.append(logits)
        toks.append(torch.argmax(logits[:, -1], dim=-1))
    return torch.stack(toks, 1), torch.cat(rows, 1)


def phase_multimodal(params_cache):
    """The two families no launcher serves, driven eagerly through the
    model's entry points as the reference drives them: whisper-medium (24
    encoder + 24 decoder layers, d_model 1024, vocab 51865) over
    WHISPER_FRAMES frame embeddings, and internvl2-1b (24 layers, d_model
    896, vocab 151655) with VLM_PATCHES patch embeddings, both at full width
    and depth, M16 ``pallas``, from a seed: MM_NEW greedy tokens after an
    MM_PROMPT-token prompt, and ``apply`` over the prompt and the tokens fed
    back against the prefill-plus-steps logits, within one bf16 quantum of
    their scale (the decode steps read the bf16 KV cache); the limb kernel
    launched.  Both sides of that check run the same kernel: the kernels
    phase holds it against its plain version at these GEMM shapes and M
    (FAMILY_SHAPES), which this phase checks against the configs."""
    counts: dict = {}
    out = {}
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    for arch in (WHISPER_ARCH, VLM_ARCH):
        release()
        model = full_width_model(policy, arch=arch)
        params = params_cache(model)
        c = model.cfg
        kn = [(c.d_model, c.n_heads * c.head_dim), (c.d_model, c.n_kv_heads * c.head_dim),
              (c.d_model, c.d_ff), (c.d_ff, c.d_model)]
        check(set(FAMILY_SHAPES[arch][1]) == set(kn),
              f"multimodal {arch}: the kernels phase held other GEMM shapes than {kn}")
        check(c.family != "vlm" or c.n_vision_tokens == VLM_PATCHES,
              f"multimodal {arch}: {c.n_vision_tokens} patches, not {VLM_PATCHES}")
        gen = torch.Generator(device="cuda").manual_seed(50)
        prompt = torch.randint(0, c.vocab, (1, MM_PROMPT), generator=gen, device="cuda")
        extra = {}
        if c.family == "encdec":
            extra["frames"] = torch.randn((1, WHISPER_FRAMES, c.d_model), generator=gen,
                                          device="cuda") * 0.02
        else:
            extra["pixel_embeds"] = torch.randn((1, c.n_vision_tokens, c.d_model),
                                                generator=gen, device="cuda") * 0.02
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the cache holds the patches too (VLM), so nothing wraps
        max_len = (c.n_vision_tokens if c.family == "vlm" else 0) + 32
        toks, step_logits = greedy_decode(model, params, prompt, MM_NEW, max_len, **extra)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches, body_launches = build.launch_counts(), build.body_launch_counts()
        seq = torch.cat([prompt, toks[:, :-1]], 1)
        batch = {"tokens": seq, **extra}
        with torch.no_grad():
            full, aux = model.apply(params, batch)
        check(bool(torch.isfinite(step_logits).all()) and bool(torch.isfinite(full).all()),
              f"multimodal {arch}: non-finite logits")
        check(tuple(full.shape) == (1, seq.shape[1], c.vocab), f"multimodal {arch}: logits shape")
        check(bool(((toks >= 0) & (toks < c.vocab)).all()), f"multimodal {arch}: token range")
        gap = float((full - step_logits).abs().max() / full.abs().max())
        check(gap <= 2.0**-8, f"multimodal {arch}: apply vs prefill + steps {gap:.3e}")
        check(launches["limb_matmul"] > 0, f"multimodal {arch}: the limb kernel launched no time")
        # the encoder's frames and the patch rows (M > 16) run the tensor-core
        # tile body, the decode steps (M = 1) the skinny one
        check(body_launches["mma"] > 0 and body_launches["skinny"] > 0,
              f"multimodal {arch}: launches by body {body_launches}")
        out[arch] = dict(family=c.family, layers=c.n_layers, encoder_layers=c.n_encoder_layers,
                         d_model=c.d_model, vocab=c.vocab, param_gb=param_gb(params),
                         extra_rows=(WHISPER_FRAMES if c.family == "encdec"
                                     else c.n_vision_tokens),
                         tokens=toks[0].tolist(), apply_vs_steps_gap_over_scale=gap,
                         tolerance=2.0**-8, launches=launches, body_launches=body_launches,
                         decode_s=decode_s,
                         peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
        del params, model, full, step_logits
    release()
    emit("multimodal", policy=policy.describe(), build_count=build.BUILD_COUNT,
         launches=counts, models=out)
    return counts


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_config(steps: int, accum: int = 1) -> TrainConfig:
    """The reference launcher's TrainConfig for ``--steps steps --accum
    accum`` at its default learning rate."""
    return TrainConfig(
        optimizer=adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=min(20, steps // 5),
                                    total_steps=steps),
        accum_steps=accum)


def train_bound_ms(cfg, params, products: int) -> dict:
    """Least time of one step on the data-sheet card: the forward GEMMs (the
    layers' weights, attention's two products over the whole sequence, the
    logits) and twice that for the backward, ``products`` f32 products per
    site (1 native, 6 at M24), over the f32 rate outside the tensor cores;
    plus AdamW's bytes (each parameter, gradient and moment read once, each
    parameter and moment written once) over the memory rate."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    d, hd = cfg.d_model, cfg.head_dim
    weights = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
    attn = 4 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ * TRAIN_SEQ * hd
    fwd = cfg.n_layers * (2 * tokens * weights + attn) + 2 * tokens * d * cfg.vocab
    n = sum(x.numel() for x in tree.leaves(params))
    ops_ms = 3 * products * fwd / F32_FLOPS * 1e3
    bytes_ms = 7 * 4 * n / HBM_BW * 1e3
    return {"bound_ms": ops_ms + bytes_ms, "gemm_ops_ms": ops_ms, "adamw_bytes_ms": bytes_ms,
            "step_tflop": 3 * products * fwd / 1e12}


def step_parts_ms(model, tcfg, params, batch, modes=None, mesh=None) -> dict:
    """Device ms of one step's forward (the loss), backward (autograd) and
    AdamW update, by CUDA events recorded between them; ``modes`` (host
    ints) are bound as device scalars, as the modal step binds them.  With
    ``mesh`` the parameters are DTensors and the parts run as the step over
    that mesh runs them (``mesh_scope``, the batch laid out first, the
    gradients put in their parameters' placements before AdamW)."""
    loss_fn = make_loss_fn(model, tcfg)
    opt = adamw.init_state(params, tcfg.optimizer)
    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    binding = contextlib.nullcontext()
    if modes is not None:
        view = DeviceModes(tuple(modes), tree.leaves(params)[0].device)
        view.write(modes)
        binding = bind_modes(view.scalars)
    with binding, mesh_scope(mesh):
        if mesh is not None:
            batch = laid_out(batch, mesh)
        torch.cuda.synchronize()
        with torch.enable_grad():
            ev[0].record()
            total, _ = loss_fn(tree.unflatten(params, live), batch)
            ev[1].record()
            grads = tree.unflatten(params, list(torch.autograd.grad(total, live)))
            ev[2].record()
        adamw.apply_updates(params, like_params(grads, params), opt, tcfg.optimizer)
        ev[3].record()
    ev[3].synchronize()
    return {"forward_ms": ev[0].elapsed_time(ev[1]), "backward_ms": ev[1].elapsed_time(ev[2]),
            "adamw_ms": ev[2].elapsed_time(ev[3])}


def profiled_step(step_fn, params, tcfg, batch) -> dict:
    """One step from a fresh state under ``torch.profiler``: the share of
    its wall time the card was busy and the kernels with the most device
    time (``device_busy``)."""
    state = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
    prof = device_busy(lambda: step_fn(state, batch), 1)
    return {"busy": prof["busy"], "kernel_ms": prof["device_ms"], "top_kernels": prof["top"]}


def train_arm(step_fn, state, data, steps: int, adapt=None):
    """``steps`` steps through ``train_loop`` (batches put on the card);
    returns (state, history, summary): losses, grad norms, step wall ms
    (``train_loop``'s dt ends in a synchronize) with their median after the
    first step, tokens/s at that median and the peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    state, hist = train_loop(step_fn, state, data, LoopConfig(total_steps=steps, log_every=1 << 30),
                             put_batch=put_batch_on("cuda"), adapt=adapt)
    step_ms = [h["dt"] * 1e3 for h in hist]
    median = statistics.median(step_ms[1:])
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    check(all(math.isfinite(x) for x in losses), "train: a non-finite loss")
    check(all(math.isfinite(g) and g > 0 for g in gnorms), f"train: grad norms {gnorms}")
    return state, hist, {
        "steps": steps, "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
        "step_ms_median_after_first": median,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def leaf_gap(got, want) -> float:
    """Largest |got - want| over the largest |want|, the worst leaf."""
    return max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(tree.leaves(got), tree.leaves(want)))


def phase_train(params_cache, card: str) -> dict:
    """The port's trainer on ``qwen1.5-0.5b`` at full width and depth (24
    layers, 1024, vocab 151936; ``model.init(0)``), at the reference
    launcher's defaults (batch 8, seq 128, lr 1e-3, ``SyntheticLM(seed=0)``),
    through ``train_loop`` and the train step a user calls:
    (a) ``native_f32``, 6 steps on one batch: the loss falls, grad norms
        finite and > 0;
    (b) ``paper_baseline`` (M24, the plain limb algebra under autograd), 3
        steps on that batch, the same checks;
    (c) the ``--adapt`` modal step from ``paper_baseline`` under a
        TrainPrecisionSchedule (SLO 0.5), 8 steps of the SyntheticLM stream:
        the mode timeline, nothing built;
    (d) ``accum_steps=2`` against 1 on the 8-row batch from the same state:
        gradients within ACCUM_GRAD_TOL of each leaf's scale, the updates
        within ACCUM_UPDATE_TOL of their norm, the loss after the step and
        the grad norms within ACCUM_LOSS_TOL;
    (e) checkpoint the state after (a), restore it onto the card: every
        leaf equal, and the next step's loss bit for bit the original's;
    (f) a train step under an M16 ``pallas`` policy raises
        NotImplementedError (the kernels have no backward pass, as the
        reference's have none) and only that; the same policy serves a
        forward under ``no_grad`` through the limb kernel;
    (g) no kernel launched across (a)-(e): the reference trains through
        the plain limb algebra too.
    Per arm: step wall ms, tokens/s, peak memory, and one step's forward,
    backward and AdamW device ms by CUDA events, beside the step's bound."""
    release()
    builds = build.BUILD_COUNT
    native = full_width_model(PRESETS["native_f32"])
    params = params_cache(native)
    cfg = native.cfg
    baseline = native.with_policy(PRESETS["paper_baseline"])
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    fixed = data.next_batch()
    batch = put_batch_on("cuda")(fixed)
    arms: dict = {}
    build.reset_launch_counts()

    # (a) native f32, 6 steps on one batch
    tcfg = train_config(6)
    step_a = make_train_step(native, tcfg)
    state_a, _, arms["a_native_f32"] = train_arm(
        step_a, {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)},
        itertools.repeat(fixed), 6)
    losses = arms["a_native_f32"]["losses"]
    check(losses[-1] < losses[0], f"train (a): the loss did not fall: {losses}")
    arms["a_native_f32"].update(step_parts_ms(native, tcfg, params, batch),
                                **train_bound_ms(cfg, params, 1),
                                **profiled_step(step_a, params, tcfg, batch))

    # (b) paper_baseline (M24 through the limb algebra), 3 steps
    tcfg = train_config(3)
    step_b = make_train_step(baseline, tcfg)
    state, _, arms["b_paper_baseline"] = train_arm(
        step_b,
        {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)},
        itertools.repeat(fixed), 3)
    del state
    losses = arms["b_paper_baseline"]["losses"]
    check(losses[-1] < losses[0], f"train (b): the loss did not fall: {losses}")
    arms["b_paper_baseline"].update(step_parts_ms(baseline, tcfg, params, batch),
                                    **train_bound_ms(cfg, params, 6),
                                    **profiled_step(step_b, params, tcfg, batch))
    release()

    # (c) the modal step under the grad-drift precision schedule
    tcfg = train_config(8)
    schedule = TrainPrecisionSchedule(ModeTable.from_policy(baseline.cfg.policy),
                                      SLO(max_err=0.5))
    start = schedule.table.describe()
    state, hist, arms["c_modal"] = train_arm(
        make_modal_step(make_train_step(baseline, tcfg)),
        {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)},
        SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0), 8,
        adapt=schedule)
    del state
    timeline = mode_timeline(hist)
    check(build.BUILD_COUNT == builds, "train (c): a shift built something")
    check(schedule.table.switches >= 1, "train (c): the schedule never shifted")
    arms["c_modal"].update(
        start=start, timeline=timeline, switches=schedule.table.switches,
        modes=[h["mode"] for h in hist], shifts=[h["mode_shift"] for h in hist],
        **step_parts_ms(baseline, tcfg, params, batch, modes=schedule.mode_scalars()),
        **train_bound_ms(cfg, params, 6))
    release()

    # (d) accum_steps=2 against 1, one step from the same state
    c1, c2 = train_config(6), train_config(6, accum=2)  # lr 1e-3 at step 1, as in (a)
    g1, _ = make_grad_fn(native, c1)(params, batch)
    g2, _ = make_grad_fn(native, c2)(params, batch)
    grad_gap = leaf_gap(g2, g1)
    del g1, g2
    torch.cuda.reset_peak_memory_stats()
    outs = {}
    for name, c in (("accum1", c1), ("accum2", c2)):
        state0 = {"params": params, "opt": adamw.init_state(params, c.optimizer)}
        t0 = time.perf_counter()
        new, m = make_train_step(native, c)(state0, batch)
        torch.cuda.synchronize()
        with torch.no_grad():
            after, _ = make_loss_fn(native, c)(new["params"], batch)
        outs[name] = dict(state=new, metrics=m, after=float(after),
                          step_ms=(time.perf_counter() - t0) * 1e3)
    old = tree.leaves(params)
    new1 = tree.leaves(outs["accum1"]["state"]["params"])
    new2 = tree.leaves(outs["accum2"]["state"]["params"])
    diff2 = sum(float(((b - a) ** 2).sum()) for a, b in zip(new1, new2))
    step2 = sum(float(((a - p) ** 2).sum()) for a, p in zip(new1, old))
    update_gap = math.sqrt(diff2 / step2)
    param_gap = max(float((a - b).abs().max()) for a, b in zip(new1, new2))
    after1, after2 = outs["accum1"]["after"], outs["accum2"]["after"]
    gn1 = float(outs["accum1"]["metrics"]["grad_norm"])
    gn2 = float(outs["accum2"]["metrics"]["grad_norm"])
    arms["d_accum"] = dict(
        grad_gap_over_scale=grad_gap, grad_tol=ACCUM_GRAD_TOL,
        update_gap_over_norm=update_gap, update_tol=ACCUM_UPDATE_TOL,
        param_gap_over_lr=param_gap / TRAIN_LR, loss_after=[after1, after2],
        loss_tol=ACCUM_LOSS_TOL, grad_norm=[gn1, gn2],
        step_ms=[outs["accum1"]["step_ms"], outs["accum2"]["step_ms"]],
        peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    what = f"train (d): {arms['d_accum']}"
    check(grad_gap <= ACCUM_GRAD_TOL, what)
    check(update_gap <= ACCUM_UPDATE_TOL, what)
    check(abs(after2 - after1) <= ACCUM_LOSS_TOL * abs(after1), what)
    check(abs(gn2 - gn1) <= ACCUM_LOSS_TOL * gn1, what)
    del outs
    release()

    # (e) checkpoint the state after (a), restore it on the card
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(TRAIN_CKPT_DIR, keep=1)
    t0 = time.perf_counter()
    mgr.save(6, state_a)
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, restored = mgr.restore(device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    leaves_a, leaves_r = tree.leaves(state_a), tree.leaves(restored)
    check(step == 6 and len(leaves_a) == len(leaves_r), "train (e): the restored tree differs")
    check(all(a.dtype == r.dtype and r.device == a.device and torch.equal(a, r)
              for a, r in zip(leaves_a, leaves_r)), "train (e): a restored leaf differs")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    next_a, ma = step_a(state_a, batch)
    next_r, mr = step_a(restored, batch)
    torch.cuda.synchronize()
    two_steps_ms = (time.perf_counter() - t0) * 1e3
    check(float(ma["loss"]) == float(mr["loss"]),
          f"train (e): next loss {float(ma['loss'])!r} against {float(mr['loss'])!r}")
    same_params = sum(torch.equal(a, b) for a, b in zip(tree.leaves(next_a["params"]),
                                                          tree.leaves(next_r["params"])))
    with open(os.path.join(TRAIN_CKPT_DIR, "step_00000006", "manifest.json")) as fh:
        manifest = json.load(fh)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    arms["e_checkpoint"] = dict(
        save_s=save_s, restore_s=restore_s, bytes=manifest["bytes"], arrays=manifest["n_arrays"],
        next_loss=[float(ma["loss"]), float(mr["loss"])], next_loss_bitwise_equal=True,
        next_params_bitwise_equal_leaves=f"{same_params}/{len(tree.leaves(next_a['params']))}",
        two_steps_ms=two_steps_ms, peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del state_a, restored, next_a, next_r
    launches = build.launch_counts()
    check(sum(launches.values()) == 0, f"train: kernels launched in (a)-(e): {launches}")
    release()

    # (f) a kernel policy under autograd raises, and only that
    kernel_model = native.with_policy(PrecisionPolicy(default=Mode.M16, impl="pallas"))
    tcfg = train_config(6)
    refused = None
    try:
        make_train_step(kernel_model, tcfg)(
            {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}, batch)
    except NotImplementedError as exc:
        refused = str(exc)
    check(refused is not None, "train (f): a train step through the kernels did not raise")
    refused_launches = build.launch_counts()
    with torch.no_grad():
        logits, _ = kernel_model.apply(params, {"tokens": batch["tokens"][:1]})
    served = build.launch_counts()
    check(bool(torch.isfinite(logits).all()) and served["limb_matmul"] > 0,
          "train (f): the kernel policy did not serve a forward under no_grad")
    del logits
    release()
    emit("train", card=card, arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, params_m=sum(x.numel() for x in tree.leaves(params)) / 1e6,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, arms=arms,
         launches_a_to_e=launches, refused=refused, launches_at_refusal=refused_launches,
         launches_serving_forward=served, build_count=build.BUILD_COUNT)
    return {}


# ---------------------------------------------------------------------------
# training over a mesh
# ---------------------------------------------------------------------------


def gathered(state):
    return tree.map_tree(lambda x: x.full_tensor(), state)


def timed_step(step_fn, state, batch) -> tuple[dict, dict, float]:
    """One step: (new state, metrics, host wall ms up to its loss on the
    host, which waits for the step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, m = step_fn(state, batch)
    check(math.isfinite(float(m["loss"])), "distributed: a non-finite loss")
    return new, m, (time.perf_counter() - t0) * 1e3


def phase_distributed(params_cache, card: str) -> dict:
    """The port's training over a ``DeviceMesh`` on the card: one rank over
    NCCL (the card is one GPU; several ranks run on the CPU in the tests),
    ``qwen1.5-0.5b`` at full width and depth (``model.init(0)``), batch 8 x
    128 from ``SyntheticLM(seed=0)``, through the train step a user calls:
    (a) the ``native_f32`` step on a (1, 1) ('data', 'model') mesh, the
        state laid out by ``param_shardings``: its losses and parameters
        after 2 steps against the unsharded step's, bit for bit (else held
        to DIST_TOL of each leaf's scale, the distance printed);
    (b) step wall ms (DIST_TIMED_PAIRS pairs in turns: unsharded, sharded,
        sharded, unsharded ...), one step's forward / backward / AdamW ms by
        CUDA events and a profiled step's busy share, sharded against
        unsharded: what DTensor's host dispatch costs;
    (c) ``grad_compression`` on a (1, 1, 1) ('pod', 'data', 'model') mesh:
        ``compressed_psum_pod`` of fixed tensors equal to
        ``compress_decompress`` bit for bit, 3 EF steps (the loss falls, the
        residual nonzero), and the bytes gathered over 'pod' int8 codes and
        f32 scales only (``compress.pod_traffic``);
    (d) ``pipeline_apply`` at S = 1 with a qwen block as the stage against
        the block applied microbatch by microbatch, forward and gradient;
    (e) the state after (a) saved from the (1, 1) mesh, restored unsharded
        and onto the (1, 1, 1) mesh as (c)'s step lays its state out (on the
        pod-free mesh, zero EF residuals beside): every leaf equal, the next
        losses bit for bit (the unsharded step's on the restored state
        against its own on the gathered state; (c)'s step's on the restored
        state against the (1, 1) mesh's on the saved one: both report the
        loss before their update);
    (g) the MoE layer over the (1, 1) mesh: ``phi3.5-moe-42b-a6.6b`` at full
        width, MOE_MESH_LAYERS of its 32 layers, ``native_f32`` with int8
        AdamW moments, the same batch: two steps sharded against unsharded
        (losses and parameters bit for bit, else within DIST_TOL), a
        prefill and MOE_MESH_DECODE cached decode steps on the mesh against
        unsharded (logits bit for bit, else within DIST_TOL), and step wall
        ms in turns (DIST_TIMED_PAIRS pairs, each step from the first
        state); it runs first, before the qwen arms;
    (f) no kernel launched and nothing built in (a)-(e) and (g)."""
    release()
    builds = build.BUILD_COUNT
    native = full_width_model(PRESETS["native_f32"])
    params = params_cache(native)
    cfg = native.cfg
    batch = put_batch_on("cuda")(
        SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0).next_batch())
    device = init_distributed("cuda")
    backend = dist.get_backend()
    check(backend == "nccl", f"distributed: the process group runs over {backend}")
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    arms: dict = {}
    build.reset_launch_counts()

    # (g) the MoE layer over the mesh
    arms["g_moe"] = moe_mesh_arm(mesh)
    release()

    # (a) sharded against unsharded, 2 steps from one state
    tcfg = train_config(6)
    plain_step = make_train_step(native, tcfg)
    mesh_step = make_train_step(native, tcfg, mesh)
    state0 = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
    sharded0 = put(state0, state_shardings(params, cfg, mesh, tcfg))
    check(all(type(x).__name__ == "DTensor" for x in tree.leaves(sharded0)),
          "distributed (a): a leaf of the laid-out state is not a DTensor")
    s_plain, s_mesh, losses = state0, sharded0, {"unsharded": [], "sharded": []}
    for _ in range(2):
        s_plain, m, _ = timed_step(plain_step, s_plain, batch)
        losses["unsharded"].append(float(m["loss"]))
        s_mesh, m, _ = timed_step(mesh_step, s_mesh, batch)
        losses["sharded"].append(float(m["loss"]))
    got = tree.leaves(gathered(s_mesh["params"]))
    want = tree.leaves(s_plain["params"])
    bitwise = (losses["sharded"] == losses["unsharded"]
               and all(torch.equal(a, b) for a, b in zip(got, want)))
    param_gap = leaf_gap(got, want)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses["sharded"], losses["unsharded"]))
    arms["a_sharded_step"] = dict(
        mesh=[1, 1], losses=losses, bitwise_equal=bitwise, param_gap_over_scale=param_gap,
        loss_gap_rel=loss_gap, tolerance=DIST_TOL,
        placements_kept=all(tuple(a.placements) == tuple(b.placements) for a, b in zip(
            tree.leaves(sharded0["params"]), tree.leaves(s_mesh["params"]))))
    check(bitwise or (param_gap <= DIST_TOL and loss_gap <= DIST_TOL),
          f"distributed (a): {arms['a_sharded_step']}")
    check(arms["a_sharded_step"]["placements_kept"], "distributed (a): placements changed")
    del got, want, s_plain
    release()

    # (b) what the mesh costs: wall in turns, parts by CUDA events, busy share
    walls = {"unsharded": [], "sharded": []}
    sp, sm = state0, sharded0
    for i in range(DIST_TIMED_PAIRS):
        order = ("unsharded", "sharded") if i % 2 == 0 else ("sharded", "unsharded")
        for name in order:
            if name == "unsharded":
                sp, _, ms = timed_step(plain_step, sp, batch)
            else:
                sm, _, ms = timed_step(mesh_step, sm, batch)
            walls[name].append(ms)
    del sp, sm
    release()
    arms["b_cost"] = {
        "step_wall_ms": walls,
        "step_wall_ms_median": {k: statistics.median(v) for k, v in walls.items()},
        "unsharded": dict(step_parts_ms(native, tcfg, params, batch),
                          **profiled_step(plain_step, params, tcfg, batch)),
        "sharded": dict(step_parts_ms(native, tcfg, sharded0["params"], batch, mesh=mesh),
                        **profiled_step(mesh_step, sharded0["params"], tcfg, batch))}
    med = arms["b_cost"]["step_wall_ms_median"]
    arms["b_cost"]["sharded_over_unsharded"] = med["sharded"] / med["unsharded"]
    release()

    # (c) int8 error-feedback compression over 'pod'
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn((1 << 20) + 100, generator=gen, device="cuda")
    red, new_r = compress.compressed_psum_pod({"w": g}, {"w": torch.zeros_like(g)}, mesh3)
    approx, resid = compress.compress_decompress(g)
    check(torch.equal(red["w"], approx) and torch.equal(new_r["w"], resid),
          "distributed (c): compressed_psum_pod != compress_decompress at one pod")
    del g, red, new_r, approx, resid
    ctcfg = dataclasses.replace(train_config(3), grad_compression=True)
    smesh = state_mesh(mesh3, ctcfg)
    cstate = {"params": params, "opt": adamw.init_state(params, ctcfg.optimizer),
              "residual": tree.map_tree(torch.zeros_like, params)}
    cstate = put(cstate, state_shardings(params, cfg, mesh3, ctcfg))
    ef_step = make_train_step(native, ctcfg, mesh3)
    compress.reset_pod_traffic()
    ef_losses, ef_ms = [], []
    for _ in range(3):
        cstate, m, ms = timed_step(ef_step, cstate, batch)
        ef_losses.append(float(m["loss"]))
        ef_ms.append(ms)
    traffic = compress.pod_traffic()
    elems = sum(x.numel() for x in tree.leaves(params))
    blocks = sum(-(-x.numel() // 512) for x in tree.leaves(params))
    res_max = max(float(x.full_tensor().abs().max()) for x in tree.leaves(cstate["residual"]))
    arms["c_compression"] = dict(
        mesh=[1, 1, 1], state_mesh=list(smesh.mesh_dim_names), losses=ef_losses,
        step_wall_ms=ef_ms, residual_max=res_max, pod_traffic_bytes=traffic)
    check(ef_losses[-1] < ef_losses[0], f"distributed (c): the loss did not fall: {ef_losses}")
    check(res_max > 0, "distributed (c): the EF residual is zero")
    check(traffic == {"int8": 3 * elems, "float32": 3 * blocks * 4},
          f"distributed (c): pod traffic {traffic}, want int8 {3 * elems} + scales")
    del cstate
    release()

    # (d) the pipeline at S = 1: a qwen block as the stage
    pmesh = make_mesh((1,), ("pod",), "cuda")
    stage = tree.map_tree(lambda x: x[0:1], params["layers"]["seg0_dense"])
    positions = torch.arange(TRAIN_SEQ, device="cuda")

    def stage_fn(p, x):
        return _block_apply(p, x, cfg, "dense", positions=positions)[0]

    xs = torch.randn((PIPE_MICROBATCHES, TRAIN_BATCH // PIPE_MICROBATCHES, TRAIN_SEQ,
                      cfg.d_model), generator=gen, device="cuda")
    live = [x.detach().requires_grad_(True) for x in tree.leaves(stage)]
    with torch.enable_grad():
        out = pipeline.pipeline_apply(stage_fn, tree.unflatten(stage, live), xs, pmesh, "pod")
        g_pipe = torch.autograd.grad(out.sum(), live)
        one = tree.map_tree(lambda x: x[0], tree.unflatten(stage, live))
        ref = torch.stack([stage_fn(one, xs[i]) for i in range(PIPE_MICROBATCHES)])
        g_ref = torch.autograd.grad(ref.sum(), live)
    fwd_gap = float((out - ref).abs().max() / ref.abs().max())
    grad_gap = leaf_gap(list(g_pipe), list(g_ref))
    arms["d_pipeline"] = dict(
        stages=1, microbatches=PIPE_MICROBATCHES, bubble=pipeline.bubble_fraction(1, 4),
        forward_bitwise=bool(torch.equal(out, ref)), forward_gap_over_scale=fwd_gap,
        grad_bitwise=all(torch.equal(a, b) for a, b in zip(g_pipe, g_ref)),
        grad_gap_over_scale=grad_gap)
    check(torch.allclose(out, ref, rtol=2e-5, atol=2e-6), f"distributed (d): {arms['d_pipeline']}")
    check(all(torch.allclose(a, b, rtol=2e-4, atol=2e-5) for a, b in zip(g_pipe, g_ref)),
          f"distributed (d): {arms['d_pipeline']}")
    del out, ref, g_pipe, g_ref, live, xs
    release()

    # (e) save from the mesh, restore unsharded and onto (1, 1, 1)
    shutil.rmtree(DIST_CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(DIST_CKPT_DIR, keep=1)
    t0 = time.perf_counter()
    mgr.save(2, s_mesh)
    mgr.wait()
    save_s = time.perf_counter() - t0
    full = gathered(s_mesh)
    t0 = time.perf_counter()
    _, restored = mgr.restore(device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_u = all(torch.equal(a, b) for a, b in zip(tree.leaves(restored), tree.leaves(full)))
    _, mu = plain_step(restored, batch)
    del restored
    _, mg = plain_step(full, batch)
    del full
    release()
    # onto the (1, 1, 1) mesh as (c)'s step holds its state: on the pod-free
    # mesh, with zero EF residuals beside (the file holds none)
    t0 = time.perf_counter()
    _, restored3 = mgr.restore(device="cuda", shardings=state_shardings(params, cfg, mesh3, ctcfg))
    torch.cuda.synchronize()
    restore3_s = time.perf_counter() - t0
    same_3 = all(torch.equal(a.full_tensor(), b.full_tensor())
                 for a, b in zip(tree.leaves(restored3), tree.leaves(s_mesh)))
    restored3["residual"] = tree.map_tree(torch.zeros_like, restored3["params"])
    _, m3 = ef_step(restored3, batch)
    del restored3
    _, mm = mesh_step(s_mesh, batch)
    with open(os.path.join(DIST_CKPT_DIR, "step_00000002", "manifest.json")) as fh:
        manifest = json.load(fh)
    shutil.rmtree(DIST_CKPT_DIR, ignore_errors=True)
    next_loss = {"restored_unsharded": float(mu["loss"]), "gathered_unsharded": float(mg["loss"]),
                 "restored_on_1x1x1_ef": float(m3["loss"]), "sharded_1x1": float(mm["loss"])}
    arms["e_elastic"] = dict(save_s=save_s, restore_unsharded_s=restore_s,
                             restore_1x1x1_s=restore3_s, bytes=manifest["bytes"],
                             process_count=manifest["process_count"], next_loss=next_loss)
    check(same_u and same_3, "distributed (e): a restored leaf differs")
    check(next_loss["restored_unsharded"] == next_loss["gathered_unsharded"]
          and next_loss["restored_on_1x1x1_ef"] == next_loss["sharded_1x1"],
          f"distributed (e): next losses {next_loss}")
    del s_mesh, sharded0, state0
    release()

    # (f) no kernel launched, nothing built
    launches = build.launch_counts()
    check(sum(launches.values()) == 0, f"distributed: kernels launched: {launches}")
    check(build.BUILD_COUNT == builds, "distributed: something was built")
    dist.destroy_process_group()
    emit("distributed", card=card, backend=backend, world=1, device=str(device),
         arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, arms=arms, launches=launches, build_count=build.BUILD_COUNT)
    return {}


def moe_mesh_arm(mesh) -> dict:
    """The distributed phase's arm (g) (see ``phase_distributed``).  One
    state at a time beside the parameters: the unsharded run's parameters
    after its two steps are held on the host while the sharded run steps."""
    t_arm = time.perf_counter()
    release()
    entry_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    model = full_width_model(PRESETS["native_f32"], MOE_MESH_LAYERS, arch=MOE_ARCH)
    cfg = model.cfg
    batch = put_batch_on("cuda")(
        SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0).next_batch())
    tcfg = train_config(6)
    tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, quantize_moments=True))
    plain_step = make_train_step(model, tcfg)
    mesh_step = make_train_step(model, tcfg, mesh)

    def first_state(sharded: bool):
        """The seed's state (made anew: a step holds no other parameters)."""
        params = model.init(0)
        state = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
        return put(state, state_shardings(params, cfg, mesh, tcfg)) if sharded else state

    losses: dict = {"unsharded": [], "sharded": []}
    walls: dict = {"unsharded": [], "sharded": []}
    want = None
    for name, fn in (("unsharded", plain_step), ("sharded", mesh_step)):
        s = first_state(name == "sharded")
        for _ in range(2):
            s, m, ms = timed_step(fn, s, batch)
            losses[name].append(float(m["loss"]))
        leaves = [x.full_tensor() if name == "sharded" else x for x in tree.leaves(s["params"])]
        if want is None:
            want = [x.cpu() for x in leaves]
        else:
            got = [x.cpu() for x in leaves]
        del s, leaves
        release()
    bitwise = losses["sharded"] == losses["unsharded"] and all(
        torch.equal(a, b) for a, b in zip(got, want))
    param_gap = leaf_gap(got, want)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses["sharded"], losses["unsharded"]))
    del got, want
    out = dict(arch=MOE_ARCH, layers=MOE_MESH_LAYERS, d_model=cfg.d_model, d_ff=cfg.d_ff,
               experts=cfg.moe_experts, top_k=cfg.moe_top_k, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               moments="int8", losses=losses, bitwise_equal=bitwise,
               param_gap_over_scale=param_gap, loss_gap_rel=loss_gap, tolerance=DIST_TOL)
    check(bitwise or (param_gap <= DIST_TOL and loss_gap <= DIST_TOL),
          f"distributed (g): steps {out}")

    # a prefill and cached decode steps, unsharded and on the mesh
    params = model.init(0)
    tokens = batch["tokens"][:MOE_MESH_ROWS, :MOE_MESH_PROMPT + MOE_MESH_DECODE]
    chunks = [tokens[:, :MOE_MESH_PROMPT]] + [
        tokens[:, i:i + 1] for i in range(MOE_MESH_PROMPT, tokens.shape[1])]
    max_len = MOE_MESH_PROMPT + MOE_MESH_DECODE
    state = model.init_decode_state(MOE_MESH_ROWS, max_len)
    plain_logits = []
    for t in chunks:
        logits, state = model.decode_step(params, t, state)
        plain_logits.append(logits)
    state = model.init_decode_state(MOE_MESH_ROWS, max_len)
    p_on = put(params, param_shardings(params, cfg, mesh))
    s_on = put(state, decode_state_shardings(state, cfg, mesh))
    mesh_logits = []
    with mesh_scope(mesh):
        for t in chunks:
            logits, s_on = model.decode_step(p_on, put(t, input_shardings(t, mesh)), s_on)
            mesh_logits.append(logits.full_tensor())
    dec_bitwise = all(torch.equal(a, b) for a, b in zip(mesh_logits, plain_logits))
    dec_gap = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(mesh_logits, plain_logits))
    out["decode"] = dict(rows=MOE_MESH_ROWS, prompt=MOE_MESH_PROMPT, steps=MOE_MESH_DECODE,
                         bitwise_equal=dec_bitwise, logit_gap_over_scale=dec_gap)
    check(dec_bitwise or dec_gap <= DIST_TOL, f"distributed (g): decode {out['decode']}")
    del p_on, s_on, state, plain_logits, mesh_logits, params
    release()

    # step wall in turns, each step from the first state (the sharded one
    # shares the unsharded one's tensors: a one-rank layout copies nothing)
    starts = {"unsharded": first_state(False)}
    starts["sharded"] = put(starts["unsharded"], state_shardings(
        starts["unsharded"]["params"], cfg, mesh, tcfg))
    for i in range(DIST_TIMED_PAIRS):
        order = ("unsharded", "sharded") if i % 2 == 0 else ("sharded", "unsharded")
        for name in order:
            fn = mesh_step if name == "sharded" else plain_step
            _, _, ms = timed_step(fn, starts[name], batch)
            walls[name].append(ms)
            release()
    del starts
    med = {k: statistics.median(v) for k, v in walls.items()}
    out.update(step_wall_ms=walls, step_wall_ms_median=med,
               sharded_over_unsharded=med["sharded"] / med["unsharded"],
               device_mem_at_entry_gb=entry_gb,
               peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               seconds=time.perf_counter() - t_arm)
    return out


# ---------------------------------------------------------------------------
# the kernels line
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the cost reader (launch.op_cost), the analysis gate and the dry run
# ---------------------------------------------------------------------------

#: the production dry-run cells the cost phase runs on this machine's CPU
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "decode_32k"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k"))
#: their policy: one f32 product a site keeps the phase near two minutes
#: (``paper_baseline``'s limb algebra makes the train cell's trace ~4x longer;
#: the full sweep runs it)
DRYRUN_POLICY = "native_f32"
DRYRUN_TIMEOUT_S = 900
DRYRUN_OUT = os.path.join(_ROOT, "build", "dryrun_cost")


def start_dryrun_cells() -> tuple[threading.Thread, list]:
    """Each of ``DRYRUN_CELLS`` on ``pod16x16`` in a process of its own on
    the CPU (``dryrun.run_cells``: a fake process group of 256 ranks, fake
    tensors), started now on a thread and read by ``finish_dryrun_cells``."""
    from repro_torch.launch.dryrun import run_cells

    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    records: list = []
    env = {"PYTHONPATH": os.path.join(_ROOT, "src"), "CUDA_VISIBLE_DEVICES": ""}
    thread = threading.Thread(target=lambda: records.extend(run_cells(
        [(arch, shape, False) for arch, shape in DRYRUN_CELLS], jobs=len(DRYRUN_CELLS),
        policy=DRYRUN_POLICY, out=DRYRUN_OUT, cell_timeout=DRYRUN_TIMEOUT_S, env=env)))
    thread.start()
    return thread, records


def finish_dryrun_cells(started) -> list[dict]:
    thread, records = started
    thread.join()
    check(len(records) == len(DRYRUN_CELLS), f"cost (d): {len(records)} records")
    out = []
    for rec in records:
        cell = rec["cell"]
        check(rec["status"] == "ok", f"cost (d): {cell}: {rec['status']}: {rec.get('error')}")
        roof = rec["roofline"]
        out.append(dict(
            cell=cell, status=rec["status"],
            t_trace_s=rec["t_trace_s"], n_events=rec["n_events"],
            flops_per_device=roof["flops_per_device"],
            hbm_bytes_per_device=roof["hbm_bytes_per_device"],
            collective_bytes_per_device=roof["collective_bytes_per_device"],
            collective_breakdown=roof["collective_breakdown"], dominant=roof["dominant"],
            t_compute_s=roof["t_compute_s"], t_memory_s=roof["t_memory_s"],
            t_collective_s=roof["t_collective_s"], memory=rec["memory"],
            model_flops_global=rec["model_flops_global"]))
    return out


def counted(rec) -> dict:
    c = rec.cost
    return {"flops": c.flops, "hbm_bytes": c.hbm_bytes, "events": rec.n_events}


def kernel_events(rec) -> dict[str, int]:
    out: dict[str, int] = {}
    for ev in rec.events:
        if ev.kind == "kernel":
            out[ev.name] = out.get(ev.name, 0) + 1
    return out


def phase_cost(params_cache, card: str) -> dict:
    """The op recorder and cost reader (``repro_torch.launch.op_cost``) on
    the card, the analysis gate, and two production dry-run cells:
    (a) ``qwen1.5-0.5b`` ``native_f32`` train step at full width and depth
        (the ``train`` phase's batch 8 x 128), recorded once on real tensors
        and once on fake ones (``FakeTensorMode``): FLOPs, bytes and events
        equal; its dot FLOPs equal to ``train_bound_ms``'s ``step_tflop``;
        the measured median step's share of ``train_bound_ms``, beside the
        time of the eager-dispatch bytes (each op one pass over memory);
    (b) ``serve_static``'s decode step (4 slots, M16 ``pallas``) recorded on
        the card and on the CPU's plain path at the same shapes: with the
        decode-attention route held off on the card (its chunk loop is the
        CPU's) the counts equal; as the program runs, the card's attention
        is one decode-attention kernel event a layer; the kernel events
        equal ``build.launch_counts()`` for that one eager step;
    (c) ``analysis.check(all_paths(quick=True, device='cuda'))``: no
        violation; ``pmm-runtime-tile`` is one mode-map launch, 0 selects;
    (d) ``DRYRUN_CELLS`` on ``pod16x16`` on this machine's CPU (started
        first, run beside (a)-(c)): status, FLOPs, bytes, collective bytes
        by kind, the dominant term, peak bytes per device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.dispatch import audit_events
    from repro_torch.analysis.hotpaths import all_paths, check as check_paths

    t_start = time.perf_counter()
    dryrun = start_dryrun_cells()
    release()
    out: dict = {"card": card}

    # (a) the train step, real and fake
    native = full_width_model(PRESETS["native_f32"])
    params = params_cache(native)
    cfg = native.cfg
    tcfg = train_config(4)
    step = make_train_step(native, tcfg)
    state = {"params": params, "opt": adamw.init_state(params, tcfg.optimizer)}
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    batch = put_batch_on("cuda")(data.next_batch())
    _, real = op_cost.record_ops(step, state, batch)
    with FakeTensorMode():
        fmodel = full_width_model(PRESETS["native_f32"])
        fparams = fmodel.init(0)
        fstate = {"params": fparams, "opt": adamw.init_state(fparams, tcfg.optimizer)}
        fbatch = {k: torch.zeros(v.shape, dtype=v.dtype, device="cuda") for k, v in batch.items()}
        _, fake = op_cost.record_ops(make_train_step(fmodel, tcfg), fstate, fbatch)
    check(counted(real) == counted(fake),
          f"cost (a): real {counted(real)} != fake {counted(fake)}")
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # the count's bytes are eager PyTorch's, one pass over memory per op: the
    # traffic of this implementation, which a fused step would lower, so the
    # share is taken against train_bound_ms (the GEMMs' FLOPs and AdamW's
    # least bytes), which no implementation can go below
    eager = op_cost.roofline_terms(real.cost)
    eager_ms = max(eager["t_compute_s"], eager["t_memory_s"], eager["t_collective_s"]) * 1e3
    median = statistics.median(walls[1:])
    hand = train_bound_ms(cfg, params, 1)
    dot = op_cost.dot_flops(real.events)
    check(abs(dot / 1e12 - hand["step_tflop"]) <= 1e-9 * hand["step_tflop"],
          f"cost (a): dot FLOPs {dot:.4e} against the hand count {hand['step_tflop']} TFLOP")
    out["a_train_native_f32"] = dict(
        real=counted(real), fake=counted(fake), dot_tflop=dot / 1e12,
        train_bound_step_tflop=hand["step_tflop"], bound_ms=hand["bound_ms"],
        eager_dispatch_terms=eager, eager_dispatch_ms=eager_ms, step_ms=walls[1:],
        step_median_ms=median, share_of_bound=hand["bound_ms"] / median)
    del real, fake, fstate, fparams, fmodel
    release()

    # (b) serve_static's decode step on the card and on the CPU's plain path
    policy = PrecisionPolicy(default=Mode.M16, impl="pallas")
    model = full_width_model(policy)
    params = params_cache(model)
    serve_cfg = ServeConfig(batch_slots=4, max_len=96)
    tokens = torch.randint(0, model.cfg.vocab, (4, 1), dtype=torch.int32, device="cuda")
    per_device = {}
    for arm in ("cuda", "cuda_chunk_loop", "cpu"):
        dev = "cpu" if arm == "cpu" else "cuda"
        m = model if dev == "cuda" else build_model(model.cfg, device="cpu")
        p = params if dev == "cuda" else tree.map_tree(lambda x: x.cpu(), params)
        eng = ServeEngine(m, p, config=serve_cfg)
        active = torch.ones((4,), dtype=torch.bool, device=dev)
        build.reset_launch_counts()
        with (mock.patch.object(layers, "decode_kernel_misses", lambda *a, **kw: ("held off",))
              if arm == "cuda_chunk_loop" else contextlib.nullcontext()):
            _, rec = op_cost.record_ops(eng._masked_step, p, tokens.to(dev), eng.state, active)
        launches = {k: v for k, v in build.launch_counts().items() if v}
        per_device[arm] = dict(counted(rec), kernel_events=kernel_events(rec), launches=launches)
        del eng, rec, p, m
    cuda_b, loop_b, cpu_b = (per_device[a] for a in ("cuda", "cuda_chunk_loop", "cpu"))
    keys = ("flops", "hbm_bytes", "events", "kernel_events")
    check({k: loop_b[k] for k in keys} == {k: cpu_b[k] for k in keys},
          f"cost (b): card (chunk loop) {loop_b} != CPU {cpu_b}")
    for arm in (cuda_b, loop_b):
        check(arm["kernel_events"] == arm["launches"] and arm["launches"],
              f"cost (b): kernel events {arm['kernel_events']} != launches {arm['launches']}")
    check(cuda_b["launches"].get("decode_attention") == model.cfg.n_layers
          and "decode_attention" not in loop_b["launches"],
          f"cost (b): decode-attention launches {cuda_b['launches']} for "
          f"{model.cfg.n_layers} layers")
    check(not cpu_b["launches"], "cost (b): the CPU arm launched a kernel")
    out["b_decode_step_m16_pallas"] = per_device
    release()

    # (c) the analysis gate on the card
    paths = all_paths(quick=True, device="cuda")
    violations, names = check_paths(paths)
    check(not violations, "cost (c): " + "; ".join(v.format() for v in violations))
    tile = next(hp for hp in paths if hp.name == "pmm-runtime-tile")
    build.reset_launch_counts()
    _, rec = op_cost.record_ops(tile.fn, *tile.args)
    stats = audit_events(rec.events)
    launched = build.launch_counts()
    check(stats["pallas_calls"] == 1 and stats["switches"] == 0
          and launched["tile_matmul"] == 1 and sum(launched.values()) == 1,
          f"cost (c): pmm-runtime-tile {stats}, launches {launched}")
    out["c_analysis"] = dict(checked=names, violations=0, pmm_runtime_tile=stats,
                             pmm_runtime_tile_launches=launched)

    out["a_c_s"] = time.perf_counter() - t_start
    emit("cost", **out)

    # (d) the production dry-run cells
    cells = finish_dryrun_cells(dryrun)
    emit("cost_dryrun", card=card, cells=cells, phase_s=time.perf_counter() - t_start)
    return dict(out, d_dryrun=cells)


# ---------------------------------------------------------------------------
# the examples' port arms
# ---------------------------------------------------------------------------


def load_example(name: str):
    """The port arm ``examples/<name>_torch.py`` as a module (the examples
    are scripts, not a package; loading one runs nothing).  The port's tests
    load the arms through this function too."""
    path = os.path.join(_ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def without_arrays(out):
    """What an arm's ``main`` returned, for the phase line: its tensors and
    numpy arrays left out, and the dicts they leave empty."""
    if isinstance(out, dict):
        kept = {k: without_arrays(v) for k, v in out.items()
                if not isinstance(v, (torch.Tensor, np.ndarray))}
        return {k: v for k, v in kept.items() if v != {}}
    if isinstance(out, (list, tuple)):
        return [without_arrays(v) for v in out]
    return out


def run_example(name: str, argv: list[str], log_dir: str) -> tuple[dict, dict, float]:
    """``main(argv)`` of ``examples/<name>_torch.py``, with its printed text
    appended to ``<log_dir>/<name>.log``; the launch counts zeroed just
    before and read just after.  Returns (what ``main`` returned, the
    counts, seconds)."""
    mod = load_example(name)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with open(os.path.join(log_dir, f"{name}.log"), "a") as fh, \
            contextlib.redirect_stdout(fh):
        out = mod.main(argv)
    torch.cuda.synchronize()
    return out, build.launch_counts(), time.perf_counter() - t0


def phase_examples(card: str) -> None:
    """The five port arms of ``examples/`` on the card, each through its
    ``main()`` at the reference script's sizes and step counts (their printed
    text goes to ``<name>.log`` beside ``--out``, else under EXAMPLES_DIR):
    (a) quickstart: the ladder through the plain limb algebra and the limb
        kernel (errors falling), ONE captured graph of the mode-map kernel
        replayed at mode bits 1-3, each replay bit-equal to the limb kernel,
        the integer product exact, 7 Strassen leaves; the limb and mode-map
        kernels launched;
    (b) strassen_demo: paper_4x4, 7 leaf products at each PE mode, errors
        falling down the ladder;
    (c) serve_batched: the streamed tokens equal the batch API's, one graph
        captured, every request complete;
    (d) train_lm: 300 steps (the loss falls); the same run preempted after
        TRAIN_LM_CUT steps and resumed for one: its loss equals the
        uninterrupted run's, bit for bit;
    (e) autoprecision_train: three 60-step curves, every loss finite.
    Nothing is built: BUILD_COUNT is 1 after the phase.  The phase line
    holds each arm's returned numbers (arrays left out), seconds and
    launches; these launches count on this line only, not on the kernels
    line, which counts the serving path's.  The phase's seconds and peak
    device memory, beside what earlier phases still held when it started."""
    release()
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases still hold
    log_dir = os.path.dirname(os.path.abspath(_OUT_PATH)) if _OUT_PATH else EXAMPLES_DIR
    os.makedirs(log_dir, exist_ok=True)
    for name in EXAMPLES:  # each log holds this run's text only
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(log_dir, f"{name}.log"))
    ckpt = os.path.join(EXAMPLES_DIR, "ckpt")
    arms = {}

    qs, counts, s = run_example("quickstart", [], log_dir)
    rt = qs["runtime"]
    check(rt["graphs"] == 1 and rt["replays"] == 3,
          f"examples (a): {rt['graphs']} graphs, {rt['replays']} replays")
    check(all(rt["bit_equal"].values()), f"examples (a): replays != limb kernel {rt['bit_equal']}")
    check(counts["limb_matmul"] > 0 and counts["tile_matmul"] > 0,
          f"examples (a): launches {counts}")
    for impl in ("xla", "pallas"):
        errs = [qs["ladder"][m][impl] for m in ("M8", "M16", "M24")]
        check(errs[0] > errs[1] > errs[2], f"examples (a): {impl} ladder {errs}")
    check(qs["auto"]["int_exact"] and qs["strassen"]["leaf_products"] == 7,
          f"examples (a): auto {qs['auto']}, strassen {qs['strassen']}")
    arms["quickstart"] = {**without_arrays(qs), "s": s, "launches": counts}

    st, counts, s = run_example("strassen_demo", [], log_dir)
    errs = [st["max_abs_err"][m] for m in ("M8", "M16", "M24")]
    check(st["leaf_products"] == 7 and set(st["leaf_calls"].values()) == {7}
          and errs[0] > errs[1] > errs[2], f"examples (b): {st['leaf_calls']} {errs}")
    arms["strassen_demo"] = {**without_arrays(st), "s": s, "launches": counts}

    sv, counts, s = run_example("serve_batched", [], log_dir)
    check(sv["stream_equals_batch"], "examples (c): streamed tokens != batch tokens")
    check(sv["graph_captures"] == 1, f"examples (c): {sv['graph_captures']} graphs captured")
    check(sv["summary"]["completed"] == sv["requests"] == 6, "examples (c): requests incomplete")
    arms["serve_batched"] = {**without_arrays(sv), "s": s, "launches": counts}

    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        full, counts, s = run_example(
            "train_lm", ["--fresh", "--ckpt-dir", os.path.join(ckpt, "full")], log_dir)
        check(full["judged"] and full["improved"] and len(full["losses"]) == 300,
              f"examples (d): loss {full['first']} -> {full['last']}")
        base = ["--ckpt-dir", os.path.join(ckpt, "cut")]
        cut, _, s_cut = run_example(
            "train_lm", base + ["--fresh", "--stop-at", str(TRAIN_LM_CUT)], log_dir)
        resumed, counts_r, s_res = run_example(
            "train_lm", base + ["--resume", "--stop-at", str(TRAIN_LM_CUT + 1)], log_dir)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(cut["checkpoints"][-1] == TRAIN_LM_CUT and resumed["start"] == TRAIN_LM_CUT,
          f"examples (d): cut {cut['checkpoints']}, resumed at {resumed['start']}")
    check(resumed["losses"] == [full["losses"][TRAIN_LM_CUT]],
          f"examples (d): resumed loss {resumed['losses']} != "
          f"{full['losses'][TRAIN_LM_CUT]} uninterrupted")
    arms["train_lm"] = {**without_arrays(full), "s": s, "s_cut": s_cut, "s_resume": s_res,
                        "launches": counts, "launches_resume": counts_r,
                        "resumed_loss": resumed["losses"][0],
                        "uninterrupted_loss": full["losses"][TRAIN_LM_CUT]}

    ap, counts, s = run_example("autoprecision_train", [], log_dir)
    check(all(len(c) == 60 and all(math.isfinite(x) for x in c) for c in ap["curves"].values()),
          "examples (e): a loss curve is short or not finite")
    arms["autoprecision_train"] = {**without_arrays(ap), "s": s, "launches": counts}

    check(build.BUILD_COUNT == 1, f"examples: kernel library built {build.BUILD_COUNT} times")
    phase_s = time.perf_counter() - t_start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("examples", card=card, arms=arms, log_dir=log_dir, build_count=build.BUILD_COUNT,
         phase_s=phase_s, peak_device_mem_gb=peak_gb, resident_at_start_gb=resident_gb)
    say({"examples_s": phase_s, "card": card})
    say({"examples_peak_device_mem_gb": peak_gb, "resident_at_start_gb": resident_gb,
         "card": card})


def kernels_line(checks, timing, main_counts) -> dict:
    """One entry per kernel: its numbers at the decode shape that dominates
    the serving path (every measured shape is in the ``kernels`` phase line)."""
    primary = {"limb_matmul": (4, 1024, 2816, 2), "tile_matmul": (4, 1024, 2816, 3),
               "quantize_mantissa": (1024, None, 2816, None),
               "limb_matmul_dd": (4, 1024, 2816, 4)}
    err_is = {
        "quantize_mantissa": "bit-exact (0 differing words)",
        "limb_matmul_dd": "largest |(hi + lo) - plain(hi + lo)| over all checked cases, the "
                          "plain version at the same K split folding at the kernel's K step "
                          "(N(0,1) operands); "
                          f"max_rel_err is that over the result's scale, held to {DD_TOL:.3e}",
    }
    out = []
    for name, info in KERNEL_INFO.items():
        rows = [r for r in timing["rows"] if r["kernel"] == name]
        if name not in primary:  # no GEMM shape: its rows at the benchmark cells' shapes
            out.append(dict(
                name=name, **info, launches=main_counts[name],
                max_err_over_bound=checks[name]["max_err_over_bound"],
                err_is="largest |kernel - plain| over the cells' shapes at M8/M16/M24 over "
                       "its bound (held_to_plain)",
                cells=[{key: r[key] for key in ("cell", "ms", "enqueue_ms", "plain_ms",
                                                "bound_ms", "bound_by", "share_of_bound",
                                                "library_ms", "valid_kv_bytes")}
                       for r in rows]))
            continue
        m, k, n, limbs = primary[name]
        at = [r for r in rows if (r["m"], r["k"], r["n"], r["limbs"]) == (m, k, n, limbs)]
        main = next(r for r in at if r.get("via", name) == name)  # the kernel alone
        entry = {}
        if name in ENTRY_POINT_KERNELS:
            launches = checks["entry_point_launches"][name]
            entry = dict(path=f"its own public entry point {ENTRY_POINT_KERNELS[name]} "
                              "(no serving path calls it, as in the reference), driven at "
                              "the serving shapes in the kernels phase",
                         library_is="torch.matmul in float64",
                         library_f32_ms=main["library_f32_ms"])
        else:
            launches = main_counts[name]
        if "ms_splits1" in main:
            entry.update(splits=main["splits"], ms_splits1=main["ms_splits1"])
        family = [r for r in rows if r.get("family")]
        if family:
            entry["family_shapes"] = [
                {key: r[key] for key in ("family", "m", "k", "n", "limbs", "splits", "path",
                                         "ms", "bound_ms", "bound_by", "share_of_bound",
                                         "plain_ms", "library_ms")}
                for r in family]
        for body in ("skinny", "mma"):
            rows_ = [p for p in checks[f"ptxas_{body}"] if p["kernel"] == name]
            if rows_:
                entry[f"ptxas_{body}"] = rows_
        runtime = [r for r in at if r.get("via") == "tile_matmul_runtime"]
        if runtime:
            entry.update(runtime_ms=runtime[0]["ms"], runtime_enqueue_ms=runtime[0]["enqueue_ms"])
        out.append(dict(
            name=name, **info, launches=launches,
            max_abs_err=checks["max_abs_err"][name],
            max_rel_err=checks["max_rel_err"][name],
            err_is=err_is.get(name, "largest |kernel - plain| over all checked cases (N(0,1) "
                                    "operands); max_rel_err is that over the result's scale, "
                                    "held to 2e-6"),
            shape={"m": m, "k": k, "n": n, "limbs": limbs},
            body=main["path"], ms=main["ms"], enqueue_ms=main["enqueue_ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            share_of_bound=main["share_of_bound"], library_ms=main["library_ms"], **entry))
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth (widths stay full)")
    ap.add_argument("--out", default=None,
                    help="also append every JSON line to this file")
    args = ap.parse_args()
    global _OUT_PATH
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        _OUT_PATH = args.out
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            raise SystemExit(f"unknown phase {p!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = phase_device()

    cache: dict = {}

    def params_cache(model):
        """Seed-made weights, shared by phases of the same model and depth
        (one set held at a time)."""
        key = (model.cfg.name, model.cfg.n_layers)
        if key not in cache:
            cache.clear()
            cache[key] = model.init(0)
        return cache[key]

    checks = timing = None
    if "kernels" in phases:
        checks, timing = phase_kernels(gen)
    main_counts = {name: 0 for name in KERNEL_INFO if name not in ENTRY_POINT_KERNELS}
    for name, fn in (("serve_static", phase_serve_static),
                     ("serve_adapt", phase_serve_adapt),
                     ("serve_grte", phase_serve_grte)):
        if name in phases:
            for kname, c in fn(params_cache, args.layers).items():
                if kname in main_counts:
                    main_counts[kname] += c
    if "serve_planned" in phases:
        phase_serve_planned(params_cache, args.layers)
    if "tune" in phases:
        phase_tune(params_cache)
    for name, fn in (("serve_spec", phase_serve_spec), ("serve_paged", phase_serve_paged),
                     ("serve_tenants", phase_serve_tenants), ("serve_ssm", phase_serve_ssm),
                     ("serve_hybrid", phase_serve_hybrid), ("serve_moe", phase_serve_moe),
                     ("serve_configs", phase_serve_configs), ("multimodal", phase_multimodal)):
        if name in phases:
            for kname, c in fn(params_cache).items():
                if kname in main_counts:
                    main_counts[kname] += c
    if "train" in phases:
        phase_train(params_cache, card)
    if "distributed" in phases:
        phase_distributed(params_cache, card)
    if "cost" in phases:
        phase_cost(params_cache, card)
    if "examples" in phases:
        phase_examples(card)
    full = all(p in phases for p in PHASES)
    if full:
        for name, c in main_counts.items():
            check(c > 0, f"kernel {name} was launched no time on the serving path")
        check(build.BUILD_COUNT == 1, "the kernel library was built more than once")
    if checks is not None:
        say(kernels_line(checks, timing, main_counts))
    say({"card": card, "wall_s": time.perf_counter() - t_start,
         "phases": phases, "build_count": build.BUILD_COUNT})
    print(card, flush=True)
    say({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
