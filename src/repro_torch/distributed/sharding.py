"""Sharding names shared with the reference's model and training code.

The reference's ``constrain`` is a mesh-aware sharding constraint that
becomes the identity outside a mesh context; this port has no mesh yet, so
``constrain`` is that identity.  ROADMAP item A13 fills in the rest of the
reference's ``distributed/sharding.py`` (meshes, parameter and input
shardings) on ``torch.distributed``.
"""
from __future__ import annotations

import torch

#: the mesh axes a batch is split over: ('pod', 'data')
BATCH_AXES = ("pod", "data")


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Sharding constraint; with no mesh (always, until A13) the identity."""
    del axes
    return x
