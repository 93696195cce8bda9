"""Hot-path registry: every step the static analyses audit.

The reference's ``repro.analysis.hotpaths`` (``src/repro/analysis/
hotpaths.py``) on the port.  Each :class:`HotPath` pins a callable, its
example arguments, a declarative dispatch
:class:`~repro_torch.analysis.dispatch.Expect`, and the flow-rule
configuration (mode args).  The registry is the contract surface: counts
are pinned against the port's own smoke configs, so a structural change to
a hot path (an extra run-time mode choice, a densified gather, a kernel
launch more or less) fails the gate until the contract is consciously
updated here.

Coverage, as the reference's:

* kernel paths — runtime-bound pmm on both impls (xla = 1 switch, tile =
  1 mode-map kernel launch / 0 switches), budget-driven
  ``tile_matmul_auto``, and the ``quantize_mantissa`` kernel;
* the train step (zero switches, zero kernel launches);
* the serving engine's steps across dense / ssm / hybrid architectures ×
  {dense, paged} cache × {plain decode, speculative round}, plus the modal
  adaptive step and the modal-verify speculative round.

``device`` is where every path runs: the CPU (the kernels' plain versions,
each charged as its kernel by its wrapper) or the card (the kernels).  The
counts are the same on both.  Counts that differ from the reference's
registry are noted where they are pinned (ROADMAP Queue C lists why each
is allowed): the reference's ``scans`` / ``whiles`` have no eager op, and
the port's ``densify`` caps are its own gathers' bytes.

``mode_args`` marks which positional arguments are mode-select scalars
(or per-site scalar dicts) for the FLOW-MODE check; every mode argument
here is a ``DeviceModes`` view (int32 device scalars), as the engine binds
them for its captured steps.  The speculative round with
``modal_verify=False`` ignores its verify table (verification runs the
static baseline step for bit identity), so only the draft table is
declared; the ``modal-verify`` cell declares both.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from repro_torch.analysis.dispatch import Expect, audit_events
from repro_torch.analysis.flow import DEFAULT_WIDEN_ALLOW, _mode_leaves, flow_violations
from repro_torch.analysis.report import Violation
from repro_torch.launch import op_cost

#: dense-attention, state-space, and hybrid (local-window) families
ARCHS = ("qwen1.5-0.5b", "mamba2-2.7b", "recurrentgemma-9b")

#: per-arch cap on the largest legitimate gather in one decode step /
#: spec round (bytes) — the densify guards.  A per-row pool densify is
#: ≥ 2× these (B × pool rows vs B × cap rows).  The port's own numbers:
#: its largest gathers are the embedding rows and the paged layout's
#: page-table reads (two rows of at most 32 cached positions)
_DECODE_GATHER_CAP = {"qwen1.5-0.5b": 8192, "mamba2-2.7b": 4096,
                      "recurrentgemma-9b": 4096}
_SPEC_GATHER_CAP = {
    ("qwen1.5-0.5b", False): 8192, ("qwen1.5-0.5b", True): 16384,
    ("mamba2-2.7b", False): 65536, ("mamba2-2.7b", True): 65536,
    ("recurrentgemma-9b", False): 4096, ("recurrentgemma-9b", True): 4096,
}


@dataclasses.dataclass(frozen=True)
class HotPath:
    name: str
    fn: Callable
    args: tuple
    expect: Expect
    mode_args: tuple[int, ...] = ()
    widen_allow: tuple = DEFAULT_WIDEN_ALLOW


def check(paths) -> tuple[list[Violation], list[str]]:
    """Run the dispatch audit + all flow rules over each path (one
    recorded run per path)."""
    violations: list[Violation] = []
    checked: list[str] = []
    for hp in paths:
        checked.append(hp.name)
        _, rec = op_cost.record_ops(hp.fn, *hp.args, hold=True)
        violations.extend(hp.expect.check(audit_events(rec.events), hp.name))
        modes = [(idx, _mode_leaves(hp.args[idx])) for idx in hp.mode_args]
        violations.extend(flow_violations(rec.events, hp.name, modes=modes,
                                          widen_allow=hp.widen_allow))
    return violations, checked


def all_paths(quick: bool = False, device=None) -> list[HotPath]:
    """The full registry (or the fast kernel/train subset) on ``device``:
    ``None`` is the GPU, and raises when there is none."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    paths = kernel_paths(device) + train_paths(device)
    if not quick:
        paths += engine_paths(device=device)
    return paths


# --------------------------------------------------------------------------
# kernel + train paths

def kernel_paths(device) -> list[HotPath]:
    import numpy as np
    import torch

    from repro_torch.core.rmpm import mp_matmul_runtime
    from repro_torch.kernels.quantize_mantissa.ops import quantize_mantissa_op
    from repro_torch.kernels.tile_matmul.ops import tile_matmul_auto

    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((64, 96)).astype(np.float32), device=device)
    b = torch.as_tensor(rng.standard_normal((96, 48)).astype(np.float32), device=device)
    mode = torch.tensor(2, dtype=torch.int32, device=device)
    blk = (32, 32, 32)

    def pmm(impl):
        def fn(a_, b_, mode_):
            return mp_matmul_runtime(a_, b_, mode_, impl=impl, block=blk,
                                     allow_auto=False, device=device)
        return fn

    return [
        # the old N-branch runtime path: exactly one run-time select, no kernels
        HotPath("pmm-runtime-xla", pmm("xla"), (a, b, mode),
                Expect(exact={"switches": 1, "pallas_calls": 0},
                       at_least={"dots": 1}),
                mode_args=(2,)),
        # the paper's contract: N modes collapse into ONE kernel launch
        HotPath("pmm-runtime-tile", pmm("tile"), (a, b, mode),
                Expect(exact={"switches": 0, "pallas_calls": 1, "dots": 0}),
                mode_args=(2,)),
        HotPath("tile-matmul-auto",
                lambda a_, b_: tile_matmul_auto(a_, b_, 2.0**-10, bm=32, bn=32, bk=32),
                (a, b),
                Expect(exact={"switches": 0, "pallas_calls": 1})),
        HotPath("quantize-mantissa",
                lambda x: quantize_mantissa_op(x, keep=8), (a,),
                Expect(exact={"switches": 0, "pallas_calls": 1})),
    ]


def train_paths(device) -> list[HotPath]:
    import torch

    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

    _cfg, model, _params = _tiny("qwen1.5-0.5b", device)
    tcfg = TrainConfig()
    state = init_train_state(model, 0, tcfg)
    step = make_train_step(model, tcfg)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32, device=device),
             "labels": torch.zeros((2, 16), dtype=torch.int32, device=device)}
    return [
        HotPath("train-step", step, (state, batch),
                Expect(exact={"switches": 0, "pallas_calls": 0},
                       at_least={"dots": 1})),
    ]


# --------------------------------------------------------------------------
# the serving engine's steps

@functools.lru_cache(maxsize=None)
def _tiny(arch: str, device):
    import dataclasses as dc

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import NATIVE_F32
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch).with_policy(NATIVE_F32)
    cfg = dc.replace(cfg, n_layers=2)
    model = build_model(cfg, device=device)
    params = model.init(0)
    return cfg, model, params


def _engine(arch: str, device: str, *, paged: bool = False, spec=None, slo=None,
            accuracy=None):
    from repro_torch.serve import CacheConfig, ServeConfig, ServeEngine
    from repro_torch.serve.config import AdaptConfig

    _cfg, model, params = _tiny(arch, device)
    cache = (CacheConfig(layout="paged", page_size=4) if paged
             else CacheConfig())
    cfg = ServeConfig(
        batch_slots=2, max_len=32, accuracy=accuracy, cache=cache,
        spec=spec, adapt=AdaptConfig(slo=slo))
    return ServeEngine(model, params, config=cfg), params


def _view(table, modes: dict, device):
    """A ``DeviceModes`` view of ``table`` holding ``modes``."""
    view = table.device_view(device)
    view.write(modes)
    return view.scalars


def engine_paths(device, archs: tuple[str, ...] = ARCHS) -> list[HotPath]:
    import torch

    from repro_torch.adapt import SLO
    from repro_torch.spec import SpecConfig, build_spec_round

    tokens = torch.zeros((2, 1), dtype=torch.int32, device=device)
    active = torch.ones((2,), dtype=torch.bool, device=device)
    paths: list[HotPath] = []

    # static decode step: no run-time mode choice, bounded gathers
    for arch in archs:
        for paged in (False, True):
            eng, params = _engine(arch, device, paged=paged)
            paths.append(HotPath(
                f"decode/{arch}/{'paged' if paged else 'dense'}",
                eng._masked_step, (params, tokens, eng.state, active),
                Expect(exact={"switches": 0, "pallas_calls": 0},
                       densify_bytes=_DECODE_GATHER_CAP[arch])))

    # speculative round: draft table runtime-bound (>= 1 switch: here one
    # mark per adapted site per draft substep, where the reference counts its
    # lax.switch equations; ROADMAP Queue C); the reference's scans (k draft
    # + verify + rollback = 6) are Python loops here
    for arch in archs:
        for paged in (False, True):
            eng, params = _engine(arch, device, paged=paged, spec=SpecConfig(k=2))
            round_fn = build_spec_round(eng.model_decode, eng._axes, 2, modal_verify=False)
            table = eng._spec_table
            args = (params, tokens, eng.state, active,
                    _view(table, table.scalars_shifted(-eng.draft_shift), device),
                    _view(table, table.scalars(), device))
            paths.append(HotPath(
                f"spec/{arch}/{'paged' if paged else 'dense'}",
                round_fn, args,
                Expect(exact={"pallas_calls": 0}, at_least={"switches": 1},
                       densify_bytes=_SPEC_GATHER_CAP[arch, paged]),
                mode_args=(4,)))

    # modal adaptive step: the ModeTable scalars must stay device scalars
    eng, params = _engine("qwen1.5-0.5b", device, slo=SLO(max_err=0.5), accuracy=2.0**-5)
    paths.append(HotPath(
        "decode-modal/qwen1.5-0.5b",
        eng._masked_step_modal,
        (params, tokens, eng.state, active,
         _view(eng.mode_table, eng.mode_table.scalars(), device)),
        Expect(exact={"pallas_calls": 0}, at_least={"switches": 1}),
        mode_args=(4,)))

    # modal-verify speculative round: BOTH tables runtime-bound
    eng, params = _engine("qwen1.5-0.5b", device, slo=SLO(max_err=0.5),
                          accuracy=2.0**-5, spec=SpecConfig(k=2))
    round_fn = build_spec_round(eng.model_decode, eng._axes, 2, modal_verify=True)
    table = eng._spec_table
    paths.append(HotPath(
        "spec-modal/qwen1.5-0.5b",
        round_fn,
        (params, tokens, eng.state, active,
         _view(table, table.scalars_shifted(-eng.draft_shift), device),
         _view(table, table.scalars(), device)),
        Expect(exact={"pallas_calls": 0}, at_least={"switches": 2}),
        mode_args=(4, 5)))
    return paths
