"""The port's ``ArchConfig`` for the ``dense_then_moe`` test family: the
``gqa`` family's, with the leading dense layers and the shared experts."""
from __future__ import annotations

import dataclasses

from reference import gqa_arch


def arch(cfg: dict, sz, policy):
    return dataclasses.replace(gqa_arch.arch(cfg, sz, policy), family="moe",
                               moe_first_dense=sz.first_dense, moe_shared_experts=sz.shared)
