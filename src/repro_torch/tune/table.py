"""Versioned JSON tuning tables: measured execution-point costs, persisted.

A :class:`TuneTable` holds one :class:`TuneRecord` per measured execution
point — (shape, RMPM mode, impl, Strassen depth, Pallas block sizes) — with
median wall time, achieved FLOP/s and max-abs error vs f64.  The planner
(repro_torch.plan.planner) resolves candidate costs against it in a
three-level order: exact-shape hit, flops-scaled nearest neighbor, roofline
fallback (with the roofline constants themselves re-fit from the table's
records via ``repro_torch.plan.cost.fit_balance``).

Tables are written by ``python -m repro_torch.tune`` to
``tuning/<backend>.json``; the schema is versioned so a stale table fails
loudly instead of silently misplanning.  The format is the reference
package's, with one difference: the port records ``torch_version`` where the
reference records ``jax_version``.  The reference's tables load unchanged
(their ``jax_version`` is not carried over).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os

from repro_torch.core.precision import Mode
from repro_torch.plan.cost import MachineBalance, estimate, fit_balance

SCHEMA_VERSION = 1

#: mode key under which impl='native' records are stored — a plain f32 dot
#: ignores the RMPM mode, so one measurement covers every mode's candidate.
NATIVE_MODE_KEY = "native"

#: neighbor interpolation gives up beyond this M*K*N ratio (either way) and
#: the planner falls back to the (re-fit) roofline instead of extrapolating
#: a measurement across orders of magnitude.
NEIGHBOR_MAX_FLOP_RATIO = 4096.0


def mode_key(mode, impl: str) -> str:
    """Table lookup key for a (mode, impl) pair: native collapses the mode."""
    if impl == "native":
        return NATIVE_MODE_KEY
    return mode if isinstance(mode, str) else Mode(mode).name


@dataclasses.dataclass(frozen=True)
class TuneRecord:
    """One measured execution point."""

    m: int
    k: int
    n: int
    mode: str  # Mode name, or NATIVE_MODE_KEY for impl='native'
    impl: str  # 'native' | 'xla' | 'pallas' | 'tile'
    depth: int  # Strassen depth
    wall_us: float  # median wall time
    flops_per_s: float  # achieved useful rate: 2*m*k*n / wall
    max_abs_err: float  # vs float64 reference
    rel_err: float  # max_abs_err / max|ref|
    block: tuple[int, int, int] | None = None  # kernel (bm, bn, bk), else None
    iters: int = 0

    @property
    def wall_s(self) -> float:
        return self.wall_us * 1e-6

    @property
    def mkn(self) -> float:
        return float(self.m) * self.k * self.n

    def key(self) -> tuple:
        return (self.m, self.k, self.n, self.mode, self.impl, self.depth)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["block"] = list(self.block) if self.block is not None else None
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TuneRecord":
        d = dict(d)
        if d.get("block") is not None:
            d["block"] = tuple(int(x) for x in d["block"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TuneTable:
    """A backend's measured cost table (records + fitted machine balance)."""

    backend: str  # 'cpu' | 'tpu' | 'gpu' — tables never cross backends
    records: tuple[TuneRecord, ...]
    align: int = 128
    torch_version: str = ""
    iters: int = 0

    # -- persistence --------------------------------------------------------

    def to_json(self) -> dict:
        bal = self.balance
        return {
            "schema_version": SCHEMA_VERSION,
            "backend": self.backend,
            "align": self.align,
            "torch_version": self.torch_version,
            "iters": self.iters,
            "balance": {
                "peak_flops": bal.peak_flops,
                "hbm_bw": bal.hbm_bw,
                "source": bal.source,
            },
            "records": [r.to_json() for r in self.records],
        }

    @classmethod
    def from_json(cls, doc: dict) -> "TuneTable":
        version = doc.get("schema_version")
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"tuning-table schema_version {version!r} != supported "
                f"{SCHEMA_VERSION}; re-run `python -m repro_torch.tune`"
            )
        return cls(
            backend=doc["backend"],
            records=tuple(TuneRecord.from_json(r) for r in doc["records"]),
            align=int(doc.get("align", 128)),
            torch_version=doc.get("torch_version", ""),
            iters=int(doc.get("iters", 0)),
        )

    def save(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "TuneTable":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- identity -----------------------------------------------------------

    @functools.cached_property
    def fingerprint(self) -> str:
        """Content digest — part of the plan-cache key, so swapping tables
        invalidates cached plans without a manual cache clear."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    # -- lookup: exact hit, then nearest neighbor ---------------------------

    @functools.cached_property
    def _exact(self) -> dict[tuple, TuneRecord]:
        idx: dict[tuple, TuneRecord] = {}
        for r in self.records:
            cur = idx.get(r.key())
            if cur is None or r.wall_us < cur.wall_us:
                idx[r.key()] = r  # best block variant wins
        return idx

    @functools.cached_property
    def _by_config(self) -> dict[tuple, list[TuneRecord]]:
        groups: dict[tuple, list[TuneRecord]] = {}
        for r in self._exact.values():
            groups.setdefault((r.mode, r.impl, r.depth), []).append(r)
        return groups

    def lookup(self, m: int, k: int, n: int, mode, impl: str, depth: int):
        """Exact-shape hit for one candidate, or None.  Among block variants
        of the same point, the fastest measurement wins."""
        return self._exact.get((m, k, n, mode_key(mode, impl), impl, depth))

    def nearest(
        self,
        m: int,
        k: int,
        n: int,
        mode,
        impl: str,
        depth: int,
        max_ratio: float = NEIGHBOR_MAX_FLOP_RATIO,
    ):
        """Closest same-config record by |log MKN ratio| -> (record, ratio).

        ``ratio`` is the candidate/record flop ratio; the caller scales the
        record's wall time by it (constant achieved FLOP/s assumption).
        Returns None when no same-config record sits within ``max_ratio``.
        """
        group = self._by_config.get((mode_key(mode, impl), impl, depth))
        if not group:
            return None
        target = float(m) * k * n
        best = min(group, key=lambda r: abs(math.log(target / r.mkn)))
        ratio = target / best.mkn
        if ratio > max_ratio or ratio < 1.0 / max_ratio:
            return None
        return best, ratio

    # -- fitted machine balance --------------------------------------------

    def record_estimate(self, r: TuneRecord):
        """The roofline's view of one record (default constants)."""
        mode = Mode.M24 if r.mode == NATIVE_MODE_KEY else Mode[r.mode]
        return estimate(r.m, r.k, r.n, mode, r.impl, r.depth, align=self.align)

    @functools.cached_property
    def balance(self) -> MachineBalance:
        """Roofline constants re-fit from this table's measurements."""
        samples = [
            (self.record_estimate(r), r.wall_s) for r in self.records if r.wall_us > 0
        ]
        return fit_balance(samples, source=f"fit:{self.backend}")
