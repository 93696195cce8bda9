"""Draws shared by every traffic kind.

Each seed gets the same multiset of sizes and gaps in another order: a
length is a quantile of its distribution at ``(i + 0.5) / n`` and the seed
only permutes them, so runs with different seeds do the same work in
another order and differ little more than two runs of one seed do.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """One independent stream of draws per use, from the run's seed."""
    return np.random.default_rng([seed % (1 << 63), stream])


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` whole lengths of the distribution ``spec`` (``dist``:
    ``lognormal`` with ``sigma`` and its ``median`` or its ``mean``, or
    ``uniform``), clipped to ``[min, max]``, in ascending order."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    if spec.get("dist", "lognormal") == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        sigma = spec["sigma"]
        median = spec["median"] if "median" in spec else spec["mean"] * math.exp(-sigma**2 / 2)
        vals = median * np.exp(sigma * z)
    elif spec["dist"] == "uniform":
        vals = lo + u * (hi + 1 - lo) - 0.5
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def shuffled_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(quantiles(spec, n))


def tokens(rng: np.random.Generator, vocab: int, n: int) -> np.ndarray:
    return rng.integers(0, vocab, n).astype(np.int32)


def poisson_arrivals(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """Arrival times (s) of a Poisson process at ``rate``: exponential gaps,
    summed.  Frozen copy of ``repro_torch.launch.serve.run_open_loop``'s
    schedule (``np.cumsum(rng.exponential(1 / rate, n))``), with the gaps
    taken as the exponential's quantiles in a seeded order (see above)."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    return np.cumsum(rng.permutation(gaps))


def expected_count(rate: float, seconds: float) -> int:
    """Arrivals to draw so the schedule outlasts ``seconds`` with margin."""
    return int(math.ceil(rate * seconds * 1.5)) + 16
