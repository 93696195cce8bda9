"""Registry of the architectures.  Ported: ``qwen1.5-0.5b`` (dense),
``mamba2-2.7b`` (ssm) and ``recurrentgemma-9b`` (hybrid); the other ids are
known and raise "not ported yet"."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig, reduce_for_smoke

_MODULES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "command-r-plus-104b": "command_r_plus_104b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "internvl2-1b": "internvl2_1b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "whisper-medium": "whisper_medium",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}
_PORTED = ("qwen1.5-0.5b", "mamba2-2.7b", "recurrentgemma-9b")

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in _PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue A item 11, "
            f"'Remaining model families'); ported: {_PORTED}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return reduce_for_smoke(get_config(arch))
