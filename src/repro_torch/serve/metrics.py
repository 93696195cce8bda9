"""Serving metrics: throughput, TTFT, per-request latency, slot occupancy,
plan-cache hits, per-tenant fairness and SLO attainment.

``ServeMetrics`` is pure bookkeeping — the engine calls the ``on_*`` hooks
and ``summary()`` folds them into one dict.  Slot occupancy is measured over
*decode steps only* (prefill is per-request work, not slot-array work):
``occupancy = sum(active slots per step) / (decode steps * slots)`` — the
fraction of the compiled step's rows doing useful work, the number that says
whether continuous batching is actually keeping the array full.

Multi-tenant accounting (DESIGN.md section Multi-tenant scheduling): every
request carries its tenant / request-class tags plus the class's step-unit
deadline, so ``tenant_summary()`` can report per tenant

  * **SLO attainment** — fraction of this tenant's deadline-carrying
    requests that completed within ``slo_steps`` *engine steps* of
    submission (step units, not wall clock: the number the CI gate
    compares between schedulers must not depend on host speed);
  * **latency percentiles** — wall-clock p50/p99 submit-to-done and TTFT
    (reporting only, never gated);
  * **decode-slot share vs entitlement** — the fraction of (decode step x
    active slot) pairs this tenant consumed, against its configured
    ``share`` weight renormalized over tenants that actually submitted.

TTFT is recorded once, at the request's *first* token: a preempted-then-
resumed request must not get a second "first token" (resume restores state,
it does not re-prefill), so ``on_first_token`` ignores repeats.

Plan-cache numbers are deltas against the engine-construction snapshot, so
they count only the planning this engine triggered (``repro_torch.plan``
caches globally).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.plan import plan_cache_stats


@dataclasses.dataclass
class RequestTimes:
    submit: float
    first_token: float | None = None
    done: float | None = None
    n_tokens: int = 0
    tenant: str = "default"
    rclass: str = "default"
    slo_steps: int | None = None  # relative deadline in engine steps
    slo_ms: float | None = None  # wall-clock target (reporting only)
    submit_step: int | None = None
    done_step: int | None = None
    preemptions: int = 0


def percentile(values: list[float], q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 100]); None on empty input."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(int(round(q / 100.0 * len(ordered) + 0.5)) - 1, 0)
    return ordered[min(rank, len(ordered) - 1)]


class ServeMetrics:
    def __init__(self, slots: int, clock=time.perf_counter):
        self.slots = slots
        self.clock = clock
        self.requests: dict[int, RequestTimes] = {}
        self.tokens_out = 0
        self.prefills = 0
        self.decode_steps = 0
        self.active_slot_steps = 0  # sum over decode steps of active slots
        self.preemptions = 0  # park/requeue events (resumes = preemptions)
        # per-tenant (decode step x active slot) consumption + entitlement
        self.tenant_slot_steps: dict[str, int] = {}
        self.tenant_shares: dict[str, float] = {}  # configured entitlement
        # runtime-adaptation observability (repro_torch.adapt): how many decode
        # steps ran under each mode label, every mode switch, every probe
        self.mode_steps: dict[str, int] = {}
        self.mode_switches = 0
        self.mode_timeline: list[tuple[int, str]] = []  # (decode_step, label)
        self.probe_errs: list[tuple[int, float]] = []  # (decode_step, err)
        # speculative decoding (repro_torch.spec): per-round draft/accept counts.
        # spec_slot_rounds counts (round, active slot) pairs — each is one
        # expensive-mode verify execution for that slot, the numerator of
        # verify_steps_per_token.
        self.spec_rounds = 0
        self.spec_slot_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.draft_shift_timeline: list[tuple[int, int]] = []  # (round, shift)
        # paged KV cache (repro_torch.serve.paged): peak concurrent in-flight
        # rows, per-step pool stats, page-pressure evictions, tier events
        self.peak_active = 0
        self.page_stats_last: dict | None = None
        self.page_occupancy_peak = 0.0
        self.page_sharing_peak = 0.0
        self.page_evictions = 0
        self.tier_events: list[tuple[int, dict]] = []  # (decode_step, stats)
        self._t_first_event: float | None = None
        self._t_last_event: float | None = None
        snap = plan_cache_stats()
        self._plan_snap = (snap.hits, snap.misses)

    # -- hooks (called by ServeEngine) --------------------------------------

    def _mark(self) -> float:
        t = self.clock()
        if self._t_last_event is not None and t < self._t_last_event:
            # perf_counter is monotonic, but an injected clock (tests) or a
            # platform regression must never mint negative latencies /
            # TTFTs — clamp every stamp to the last one seen
            t = self._t_last_event
        if self._t_first_event is None:
            self._t_first_event = t
        self._t_last_event = t
        return t

    def set_tenant_shares(self, shares: dict[str, float]) -> None:
        """Configured entitlement weights (Tenant.share) for the fairness
        report — set once by the engine at construction."""
        self.tenant_shares = dict(shares)

    def on_submit(self, rid: int, *, tenant: str = "default",
                  rclass: str = "default", slo_steps: int | None = None,
                  slo_ms: float | None = None,
                  step: int | None = None) -> None:
        self.requests[rid] = RequestTimes(
            submit=self._mark(), tenant=tenant, rclass=rclass,
            slo_steps=slo_steps, slo_ms=slo_ms, submit_step=step)

    def on_first_token(self, rid: int) -> None:
        """First token of a request's life.  Repeats are ignored: a
        preempted-then-resumed request already produced its first token, so
        its TTFT must keep the original timestamp."""
        if self.requests[rid].first_token is not None:
            return
        self.prefills += 1
        self.requests[rid].first_token = self._mark()

    def on_token(self, rid: int) -> None:
        self.tokens_out += 1
        self.requests[rid].n_tokens += 1

    def on_preempt(self, rid: int) -> None:
        """One park/requeue of a running request (engine preemption path)."""
        self.preemptions += 1
        self.requests[rid].preemptions += 1

    def on_decode_step(self, n_active: int, mode: str | None = None,
                       tenant_active: dict[str, int] | None = None) -> None:
        self.decode_steps += 1
        self.active_slot_steps += n_active
        self.peak_active = max(self.peak_active, n_active)
        if tenant_active:
            for name, n in tenant_active.items():
                self.tenant_slot_steps[name] = (
                    self.tenant_slot_steps.get(name, 0) + n)
        if mode is not None:
            self.mode_steps[mode] = self.mode_steps.get(mode, 0) + 1
            if not self.mode_timeline or self.mode_timeline[-1][1] != mode:
                self.mode_timeline.append((self.decode_steps, mode))
        self._mark()

    def on_mode_switch(self) -> None:
        """One applied mode-table change (repro_torch.adapt controller decision).
        The timeline itself is recorded by ``on_decode_step`` — this only
        counts reconfigurations."""
        self.mode_switches += 1

    def on_probe(self, err: float) -> None:
        self.probe_errs.append((self.decode_steps, float(err)))

    def on_spec_round(self, n_active: int, *, drafted: int, accepted: int,
                      emitted: int) -> None:
        """One speculative round (repro_torch.spec): ``drafted`` cheap-mode draft
        tokens proposed across the active slots, ``accepted`` of them kept
        by verify, ``emitted`` tokens actually produced (accepted prefixes
        plus correction tokens, clamped to each slot's budget)."""
        self.spec_rounds += 1
        self.spec_slot_rounds += n_active
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted

    def on_draft_shift(self, round_idx: int, shift: int) -> None:
        """One applied acceptance-controller move of the draft-mode shift."""
        self.draft_shift_timeline.append((round_idx, shift))

    def on_page_stats(self, stats: dict) -> None:
        """Per-step paged-pool snapshot (occupancy, sharing, tier mix) —
        the last snapshot and the occupancy peak are kept."""
        self.page_stats_last = stats
        self.page_occupancy_peak = max(self.page_occupancy_peak,
                                       stats.get("occupancy", 0.0))
        self.page_sharing_peak = max(self.page_sharing_peak,
                                     stats.get("sharing_ratio", 0.0))

    def on_page_evict(self) -> None:
        """One page-pressure eviction: the pool could not grow an active
        row, so the scheduler's victim parked (on top of the on_preempt the
        engine's park path already records)."""
        self.page_evictions += 1

    def on_page_tier(self, step: int, stats: dict) -> None:
        """One applied tier tick (demotions/promotions + measured
        residuals, repro_torch.adapt.pages)."""
        self.tier_events.append((step, stats))

    def on_done(self, rid: int, step: int | None = None) -> None:
        r = self.requests[rid]
        r.done = self._mark()
        r.done_step = step

    # -- derived -------------------------------------------------------------

    def ttft(self, rid: int) -> float | None:
        """Time to first token, or None when the rid is unknown or has no
        first token yet (never raises — callers poll mid-flight rids)."""
        r = self.requests.get(rid)
        if r is None or r.first_token is None:
            return None
        return r.first_token - r.submit

    def latency(self, rid: int) -> float | None:
        """Submit-to-done latency, or None when the rid is unknown or not
        done yet (never raises — callers poll mid-flight rids)."""
        r = self.requests.get(rid)
        if r is None or r.done is None:
            return None
        return r.done - r.submit

    @property
    def acceptance_rate(self) -> float | None:
        """Fraction of drafted tokens the verify chain accepted."""
        if not self.spec_drafted:
            return None
        return self.spec_accepted / self.spec_drafted

    @property
    def verify_steps_per_token(self) -> float | None:
        """Expensive-mode verify *dispatches* per emitted decode token —
        (round, active slot) pairs over tokens emitted by rounds.  This is
        the sequential-latency unit of decode (the baseline engine pays
        exactly 1.0 per token by construction; any acceptance pushes it
        below 1), NOT a FLOP count: the verify chain still computes every
        position, it just does so inside one dispatch per round.  The
        FLOP-level saving comes separately from the draft substeps running
        the cheap limb modes (DESIGN.md section Speculative decoding)."""
        if not self.spec_emitted:
            return None
        return self.spec_slot_rounds / self.spec_emitted

    @property
    def occupancy(self) -> float:
        if not self.decode_steps:
            return 0.0
        return self.active_slot_steps / (self.decode_steps * self.slots)

    @property
    def mode_occupancy(self) -> dict[str, float]:
        """Fraction of decode steps spent under each mode label — the
        serving-level view of how often the reconfigurable multiplier
        actually ran in each configuration."""
        total = sum(self.mode_steps.values())
        if not total:
            return {}
        return {m: n / total for m, n in sorted(self.mode_steps.items())}

    def tenant_summary(self) -> dict[str, dict]:
        """Per-tenant fairness / SLO view.  Tenants appear when they were
        declared with a share or submitted at least one request; a tenant
        with zero completed requests reports None percentiles and, if it
        submitted deadline-carrying requests, an attainment of 0.0 (a
        missed deadline is a miss, not a gap in the data).

        ``attainment``: over this tenant's requests whose class carries
        ``slo_steps``, the fraction completed within that many engine steps
        of submission (None when the tenant has no deadline-carrying
        requests).  ``slot_share``: measured fraction of decode (step x
        active slot) pairs; ``entitlement``: the tenant's configured share
        weight renormalized over tenants that submitted anything."""
        names = sorted(set(self.tenant_shares)
                       | {r.tenant for r in self.requests.values()})
        submitted_names = {r.tenant for r in self.requests.values()}
        ent_total = sum(self.tenant_shares.get(n, 1.0)
                        for n in submitted_names) or 1.0
        total_slot_steps = sum(self.tenant_slot_steps.values())
        out: dict[str, dict] = {}
        for name in names:
            rs = [r for r in self.requests.values() if r.tenant == name]
            lats = [r.done - r.submit for r in rs if r.done is not None]
            ttfts = [r.first_token - r.submit for r in rs
                     if r.first_token is not None]
            with_slo = [r for r in rs if r.slo_steps is not None]
            met = sum(
                1 for r in with_slo
                if r.done_step is not None and r.submit_step is not None
                and r.done_step - r.submit_step <= r.slo_steps)
            ms_targets = [r for r in rs if r.slo_ms is not None]
            ms_met = sum(1 for r in ms_targets if r.done is not None
                         and (r.done - r.submit) * 1e3 <= r.slo_ms)
            out[name] = {
                "submitted": len(rs),
                "completed": sum(1 for r in rs if r.done is not None),
                "tokens": sum(r.n_tokens for r in rs),
                "preemptions": sum(r.preemptions for r in rs),
                "classes": sorted({r.rclass for r in rs}),
                "attainment": (met / len(with_slo)) if with_slo else None,
                "attainment_ms": (ms_met / len(ms_targets)
                                  if ms_targets else None),
                "latency_p50_s": percentile(lats, 50),
                "latency_p99_s": percentile(lats, 99),
                "ttft_p50_s": percentile(ttfts, 50),
                "slot_share": (
                    self.tenant_slot_steps.get(name, 0) / total_slot_steps
                    if total_slot_steps else 0.0),
                "entitlement": (
                    self.tenant_shares.get(name, 1.0) / ent_total
                    if name in submitted_names else 0.0),
            }
        return out

    def plan_cache_delta(self) -> dict:
        snap = plan_cache_stats()
        return {
            "hits": snap.hits - self._plan_snap[0],
            "misses": snap.misses - self._plan_snap[1],
            "entries": snap.entries,
        }

    def summary(self) -> dict:
        ttfts = [self.ttft(r) for r in self.requests if self.ttft(r) is not None]
        lats = [self.latency(r) for r in self.requests if self.latency(r) is not None]
        span = (
            (self._t_last_event - self._t_first_event)
            if self._t_first_event is not None and self._t_last_event is not None
            else 0.0
        )
        return {
            "requests": len(self.requests),
            "completed": len(lats),
            "tokens_out": self.tokens_out,
            "tok_s": self.tokens_out / span if span > 0 else 0.0,
            "ttft_mean_s": sum(ttfts) / len(ttfts) if ttfts else None,
            "latency_mean_s": sum(lats) / len(lats) if lats else None,
            "decode_steps": self.decode_steps,
            "occupancy": self.occupancy,
            "preemptions": self.preemptions,
            "tenants": self.tenant_summary(),
            "mode_switches": self.mode_switches,
            "mode_occupancy": self.mode_occupancy,
            "probe_err_max": (max(e for _, e in self.probe_errs)
                              if self.probe_errs else None),
            "probe_err_mean": (sum(e for _, e in self.probe_errs)
                               / len(self.probe_errs)
                               if self.probe_errs else None),
            "spec_rounds": self.spec_rounds,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_rejected": self.spec_drafted - self.spec_accepted,
            "spec_emitted": self.spec_emitted,
            "acceptance_rate": self.acceptance_rate,
            "verify_steps_per_token": self.verify_steps_per_token,
            "draft_shift_moves": len(self.draft_shift_timeline),
            "peak_active": self.peak_active,
            "pages": self._pages_summary(),
            "plan_cache": self.plan_cache_delta(),
        }

    def _pages_summary(self) -> dict | None:
        if self.page_stats_last is None:
            return None
        s = dict(self.page_stats_last)
        s["occupancy_peak"] = self.page_occupancy_peak
        s["sharing_peak"] = self.page_sharing_peak
        s["page_evictions"] = self.page_evictions
        s["tier_ticks"] = len(self.tier_events)
        s["tier_demoted"] = sum(t.get("demoted", 0)
                                for _, t in self.tier_events)
        s["tier_promoted"] = sum(t.get("promoted", 0)
                                 for _, t in self.tier_events)
        s["tier_err_max"] = (max(t.get("err", 0.0)
                                 for _, t in self.tier_events)
                             if self.tier_events else None)
        return s

    def format_summary(self) -> str:
        s = self.summary()
        ttft = f"{s['ttft_mean_s']*1e3:.1f}ms" if s["ttft_mean_s"] is not None else "-"
        lat = f"{s['latency_mean_s']*1e3:.1f}ms" if s["latency_mean_s"] is not None else "-"
        pc = s["plan_cache"]
        out = (
            f"{s['tokens_out']} tokens from {s['completed']}/{s['requests']} "
            f"requests | {s['tok_s']:.1f} tok/s | ttft {ttft} | latency {lat} "
            f"| occupancy {s['occupancy']:.2f} over {s['decode_steps']} steps "
            f"| plan cache +{pc['misses']} plans / {pc['hits']} hits"
        )
        if s["preemptions"]:
            out += f" | {s['preemptions']} preemptions"
        if s["mode_occupancy"]:
            occ = " ".join(f"{m}:{f:.2f}" for m, f in s["mode_occupancy"].items())
            out += f" | modes {occ} ({s['mode_switches']} switches)"
        if s["probe_err_max"] is not None:
            out += (f" | probe err mean {s['probe_err_mean']:.2e} "
                    f"max {s['probe_err_max']:.2e}")
        if s["spec_rounds"]:
            out += (f" | spec {s['spec_rounds']} rounds, acceptance "
                    f"{s['acceptance_rate']:.2f}, verify-steps/token "
                    f"{s['verify_steps_per_token']:.2f}"
                    f" ({s['draft_shift_moves']} draft-shift moves)")
        if s["pages"] is not None:
            p = s["pages"]
            out += (f" | pages {p['pages_used']}/{p['pages_total']} "
                    f"(peak occ {p['occupancy_peak']:.2f}, "
                    f"sharing {p['sharing_ratio']:.2f}, "
                    f"{p['page_evictions']} evictions)")
            if p["tier_ticks"]:
                err = (f"{p['tier_err_max']:.2e}"
                       if p["tier_err_max"] is not None else "-")
                out += (f" | tiers {p['tier_demoted']} demoted / "
                        f"{p['tier_promoted']} promoted, err max {err}")
        return out

    def format_tenants(self) -> str:
        """One line per tenant: the fairness / attainment report."""
        rows = []
        for name, t in self.tenant_summary().items():
            att = (f"{t['attainment']:.0%}" if t["attainment"] is not None
                   else "-")
            p50 = (f"{t['latency_p50_s']*1e3:.0f}ms"
                   if t["latency_p50_s"] is not None else "-")
            p99 = (f"{t['latency_p99_s']*1e3:.0f}ms"
                   if t["latency_p99_s"] is not None else "-")
            rows.append(
                f"tenant {name}: {t['completed']}/{t['submitted']} done "
                f"({','.join(t['classes']) or '-'}) | attainment {att} "
                f"| p50 {p50} p99 {p99} | share {t['slot_share']:.2f} "
                f"(entitled {t['entitlement']:.2f}) "
                f"| {t['preemptions']} preemptions"
            )
        return "\n".join(rows)
