"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them.

* ``BENCHMARK.json`` (the checkout's root): the cell, its configuration and
  traffic names, and which metrics it reports;
* ``perfbench/configs/<config>.json``: the model's published sizes, how
  it is served (``serving``) and its family (``reference``);
* ``perfbench/reference/<family>.py``: everything that depends on the
  architecture (sizes, weights, the plain reference, the check's row
  policy, the work counts), and ``<family>_arch.py`` beside it: the port's
  ``ArchConfig``;
* ``perfbench/traffic/<traffic>.json``: the mix, read by the generator
  ``perfbench/traffic/kinds/<kind>.py``;
* ``perfbench/cells/<workload>.json``: the limits ``correct`` is held to;
* ``perfbench/metrics/<metric>.py``: one reader per metric.

A new cell, mix, configuration, family or metric is new files and new
entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise SystemExit(f"perfbench: no file {path}")
    name = f"perfbench_{path.parent.name}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs, as an import would be (a dataclass looks
    # its module up)
    sys.modules[name] = mod
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
    #: the configuration's family module (``perfbench/reference/<family>.py``)
    family: ModuleType

    @property
    def sizes(self):
        return self.family.sizes(self.config)

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
    config = _json(root / cfg["file"])
    if "reference" not in config:
        raise SystemExit(f"perfbench: {cfg['file']} names no family (\"reference\")")
    return Cell(name, bench, wl, config, _json(here / "traffic" / f"{wl['traffic']}.json"),
                _json(here / "cells" / f"{name}.json"), root,
                _module(here / "reference" / f"{config['reference']}.py"))


def traffic_kind(cell: Cell):
    return _module(cell.root / "perfbench" / "traffic" / "kinds" / f"{cell.traffic['kind']}.py")


def metric_reader(cell: Cell, name: str):
    return _module(cell.root / "perfbench" / "metrics" / f"{name}.py")


def arch_of(cell: Cell, mode: str | None = None, impl: str | None = None):
    """The port's ``ArchConfig`` for the cell's configuration, from its
    family's ``<family>_arch.py``; its precision mode and implementation
    replaced by ``mode`` and ``impl`` where given (the low-precision
    control; a plain f32 witness)."""
    from repro_torch.core import Mode, PrecisionPolicy

    srv = cell.config["serving"]
    policy = PrecisionPolicy(default=Mode[mode or srv["mode"]], impl=impl or srv["impl"])
    here = cell.root / "perfbench" / "reference"
    mapping = _module(here / f"{cell.config['reference']}_arch.py")
    return mapping.arch(cell.config, cell.sizes, policy)
