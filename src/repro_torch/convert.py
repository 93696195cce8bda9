"""Parameters of the JAX package turned into the port's parameters.

The reference's parameter pytree (``repro.models.lm.LanguageModel.init``)
keeps the layers of a segment stacked on a leading axis under
``params["layers"]["seg0_dense"]`` (``"seg0_ssm"`` for Mamba-2), the
hybrid's supergroup stacked under ``params["super"]`` and its remainder
layers unstacked under ``params["rem"]``, and its weights as
``(d_in, d_out)``, used as ``x @ w``.  The port keeps exactly that layout,
so conversion is a walk that turns every numpy leaf into a float32 tensor on
the target device — after which both packages compute the same function.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

#: the stacked segments of the families ported with a ``params["layers"]``
#: tree (the hybrid has ``super`` / ``rem`` instead)
PORTED_SEGMENTS = ({"seg0_dense"}, {"seg0_ssm"})
#: pattern slots the hybrid's ``super`` / ``rem`` trees may hold
_HYBRID_KINDS = ("rec", "attn_local")


def _check_family(tree: dict) -> None:
    """Refuse the trees of families the port does not run (moe, vlm,
    enc-dec): their segments, encoder stacks or extra blocks."""
    if "enc_layers" in tree:
        raise NotImplementedError("the enc-dec family is not ported (an 'enc_layers' tree)")
    if "layers" in tree:
        if "super" in tree or "rem" in tree or set(tree["layers"]) not in PORTED_SEGMENTS:
            raise NotImplementedError(
                f"only the dense, ssm and hybrid families are ported (one "
                f"'seg0_dense' or 'seg0_ssm' segment, or 'super'/'rem'); got "
                f"segments {sorted(tree['layers'])}")
        return
    if "super" not in tree:
        raise NotImplementedError(
            "only the dense, ssm and hybrid families are ported: the tree has "
            "neither 'layers' nor 'super'")
    for top in ("super", "rem"):
        for key in tree.get(top, {}):
            if key.split("_", 1)[-1] not in _HYBRID_KINDS:
                raise NotImplementedError(
                    f"hybrid block {top}/{key}: only {_HYBRID_KINDS} blocks are ported")


def params_from_jax(tree: Any, device=None) -> Any:
    """``tree``: the reference's parameter pytree with numpy (or
    numpy-convertible) leaves, dense, ssm or hybrid family.  Returns the
    port's parameter dict on ``device`` (None -> the GPU; raises when there
    is none)."""
    _check_family(tree)
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

    return walk(tree)
