"""Parameters of the JAX package turned into the port's parameters.

The reference's parameter pytree (``repro.models.lm.LanguageModel.init``)
keeps the layers of a segment stacked on a leading axis under
``params["layers"]["seg{i}_{kind}"]`` (``seg0_dense``, ``seg0_ssm``,
``seg0_moe``, ``seg0_dense`` + ``seg1_moe`` for Kimi-K2, ``seg0_dec`` beside
the enc-dec family's stacked ``params["enc_layers"]``), the hybrid's
supergroup stacked under ``params["super"]`` and its remainder layers
unstacked under ``params["rem"]``, and its weights as ``(d_in, d_out)``,
used as ``x @ w`` (expert weights as (E, d_in, d_out)).  The port keeps
exactly that layout, so conversion is a walk that turns every numpy leaf
into a float32 tensor on the target device — after which both packages
compute the same function.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

#: block kinds a ``params["layers"]`` segment may hold, and the hybrid's
#: ``super`` / ``rem`` pattern slots
_SEGMENT_KINDS = ("dense", "moe", "ssm", "dec")
_HYBRID_KINDS = ("rec", "attn_local")


def _kind(key: str, prefix: str) -> str | None:
    """``seg0_moe`` -> ``moe`` (``prefix`` "seg"), ``l2_attn_local`` ->
    ``attn_local`` (``prefix`` "l"); None when ``key`` is not so named."""
    head, _, kind = key.partition("_")
    if not head.startswith(prefix) or not head[len(prefix):].isdigit():
        return None
    return kind


def _check_tree(tree: dict) -> None:
    """Refuse a tree the port's model cannot read: a segment or pattern slot
    of an unknown block kind, an encoder stack without a decoder segment, or
    neither ``layers`` nor ``super``."""
    if "layers" in tree:
        kinds = [_kind(key, "seg") for key in tree["layers"]]
        if "super" in tree or "rem" in tree or not all(k in _SEGMENT_KINDS for k in kinds):
            raise NotImplementedError(
                f"unknown layer segments {sorted(tree['layers'])} (blocks "
                f"{_SEGMENT_KINDS}, or a hybrid's 'super'/'rem')")
        if ("enc_layers" in tree) != ("dec" in kinds):
            raise NotImplementedError(
                "an enc-dec tree needs both an 'enc_layers' stack and a 'seg0_dec' segment")
        return
    if "super" not in tree:
        raise NotImplementedError("the tree has neither 'layers' nor 'super'")
    for top in ("super", "rem"):
        for key in tree.get(top, {}):
            if _kind(key, "l") not in _HYBRID_KINDS:
                raise NotImplementedError(
                    f"hybrid block {top}/{key}: only {_HYBRID_KINDS} blocks exist")


def params_from_jax(tree: Any, device=None) -> Any:
    """``tree``: the reference's parameter pytree with numpy (or
    numpy-convertible) leaves, of any family.  Returns the port's parameter
    dict on ``device`` (None -> the GPU; raises when there is none)."""
    _check_tree(tree)
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

    return walk(tree)
