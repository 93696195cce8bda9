"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them.

* ``BENCHMARK.json`` (the checkout's root): the cell, its configuration and
  traffic names, and which metrics it reports;
* ``perfbench/configs/<config>.json``: the model's published sizes and how
  it is served (``serving``);
* ``perfbench/traffic/<traffic>.json``: the mix, read by the generator
  ``perfbench/traffic/kinds/<kind>.py``;
* ``perfbench/cells/<workload>.json``: the limits ``correct`` is held to;
* ``perfbench/metrics/<metric>.py``: one reader per metric.

A new cell, mix, configuration or metric is new files and new entries;
nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from reference.model import Sizes

ROOT = Path(__file__).resolve().parents[2]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.parent.name}_{path.stem}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    root: Path

    @property
    def sizes(self) -> Sizes:
        return sizes_of(self.config)

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = found[0]
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    here = root / "perfbench"
    return Cell(name, bench, wl, _json(root / cfg["file"]),
                _json(here / "traffic" / f"{wl['traffic']}.json"),
                _json(here / "cells" / f"{name}.json"), root)


def traffic_kind(cell: Cell):
    return _module(cell.root / "perfbench" / "traffic" / "kinds" / f"{cell.traffic['kind']}.py")


def metric_reader(cell: Cell, name: str):
    return _module(cell.root / "perfbench" / "metrics" / f"{name}.py")


def sizes_of(cfg: dict) -> Sizes:
    """The reference's sizes from a configuration file's published keys."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    srv = cfg["serving"]
    return Sizes(
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], head_dim=cfg.get("head_dim") or d // h,
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        experts=cfg.get("num_local_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
        capacity_factor=srv.get("moe_capacity_factor", 1.25),
        group_size=srv.get("moe_group_size", 512))


def arch_of(cfg: dict, mode: str | None = None, impl: str | None = None):
    """The port's ``ArchConfig`` for a configuration file, its precision
    mode and implementation replaced by ``mode`` and ``impl`` where given
    (the low-precision control; a plain f32 witness)."""
    from repro_torch.core import Mode, PrecisionPolicy
    from repro_torch.models.config import ArchConfig

    sz, srv = sizes_of(cfg), cfg["serving"]
    policy = PrecisionPolicy(default=Mode[mode or srv["mode"]], impl=impl or srv["impl"])
    return ArchConfig(
        name=cfg["name"], family="moe" if sz.moe else "dense", n_layers=sz.n_layers,
        d_model=sz.d_model, n_heads=sz.n_heads, n_kv_heads=sz.n_kv_heads, d_ff=sz.d_ff,
        vocab=sz.vocab, head_dim=sz.head_dim, rope_theta=sz.rope_theta, norm_eps=sz.norm_eps,
        moe_experts=sz.experts, moe_top_k=sz.top_k, moe_capacity_factor=sz.capacity_factor,
        moe_group_size=sz.group_size, attn_chunk=srv.get("attn_chunk", 1024),
        param_dtype=srv["param_dtype"], kv_cache_dtype=srv["kv_cache_dtype"], policy=policy)
