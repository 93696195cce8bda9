"""Parameters of the JAX package turned into the port's parameters.

The reference's parameter pytree (``repro.models.lm.LanguageModel.init``)
keeps the layers of a segment stacked on a leading axis under
``params["layers"]["seg0_dense"]`` and its weights as ``(d_in, d_out)``, used
as ``x @ w``.  The port keeps exactly that layout, so conversion is a walk
that turns every numpy leaf into a float32 tensor on the target device —
after which both packages compute the same function.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(tree: Any, device=None) -> Any:
    """``tree``: the reference's parameter pytree with numpy (or
    numpy-convertible) leaves, dense family.  Returns the port's parameter
    dict on ``device`` (None -> the GPU; raises when there is none)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

    out = walk(tree)
    layers = out.get("layers", {})
    if set(layers) != {"seg0_dense"}:
        raise NotImplementedError(
            f"only the dense family is ported (one 'seg0_dense' segment); "
            f"got segments {sorted(layers)}")
    return out
