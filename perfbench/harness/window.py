"""End-to-end metrics from a window's timeline (host clock)."""
from __future__ import annotations

import math
import statistics

from harness.drive import Timeline


def percentile(values: list[float], q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 100]): the smallest value with at
    least q % of the values at or below it; None on empty input.  Copied
    from ``repro_torch.serve.metrics.percentile``, whose
    ``round(q / 100 * n + 0.5)`` rounds half to even and so reads one rank
    high where ``q / 100 * n`` is odd and whole (p95 of 100 values: the
    96th)."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(math.ceil(q * len(ordered) / 100.0) - 1, 0)
    return ordered[min(rank, len(ordered) - 1)]


def in_window(tl: Timeline, t: float) -> bool:
    return tl.t_open < t <= tl.t_close


def output_tokens(tl: Timeline) -> int:
    return sum(1 for ts in tl.token_t.values() for t in ts if in_window(tl, t))


def output_tokens_per_s(tl: Timeline) -> float:
    """Every token that reached the host in the window, over its seconds."""
    return output_tokens(tl) / (tl.t_close - tl.t_open)


def token_gaps_ms(tl: Timeline) -> list[float]:
    """Every gap between two consecutive tokens of one request, both in the
    window, from all requests."""
    out = []
    for ts in tl.token_t.values():
        for a, b in zip(ts, ts[1:]):
            if in_window(tl, a) and in_window(tl, b):
                out.append((b - a) * 1e3)
    return out


def ttft_ms(tl: Timeline) -> list[float]:
    """Time to first token of every request due in the window, from its due
    time; one still without a token at the close counts what it has waited
    by then."""
    out = []
    for rid, due in tl.due.items():
        if not tl.t_open <= due < tl.t_close:
            continue
        ts = tl.token_t[rid]
        first = ts[0] if ts and ts[0] <= tl.t_close else tl.t_close
        out.append((first - due) * 1e3)
    return out


def arrival_lag_ms(tl: Timeline) -> list[float]:
    """How late each request of the window was handed to the engine after
    its due time; one never handed over counts its lag at the close."""
    return [(tl.submitted.get(rid, tl.t_close) - due) * 1e3 for rid, due in tl.due.items()
            if tl.t_open <= due < tl.t_close]


def decode_only_step_ms(tl: Timeline) -> list[float]:
    """Host wall of each step of the window that admitted nothing."""
    return [(s.t1 - s.t0) * 1e3 for s in tl.steps
            if not s.admitted and s.decode and tl.t_open <= s.t0 and s.t1 <= tl.t_close]


def median(values: list[float]) -> float | None:
    return statistics.median(values) if values else None


def decode_contexts(tl: Timeline) -> list[tuple]:
    """(step, keys each row's cache holds) of every step with a decode: a
    row's prompt plus the tokens it was served before the step (the token
    the step feeds is appended before attention)."""
    served: dict[int, int] = {}
    out = []
    for st in tl.steps:
        for rid in st.admitted:
            served[rid] = 1
        if st.decode:
            out.append((st, [len(tl.prompts[r]) + served[r] for r in st.decode]))
            for rid in st.decode:
                served[rid] += 1
    return out
