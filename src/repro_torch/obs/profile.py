"""Profiling hooks around the serving phases.

``PhaseProfiler`` accumulates wall time and token counts per phase
(prefill, decode, spec) from timings the engine already takes, and detects
recompiles by watching counts that grow only when something is built or
captured: each compiled step's CUDA-graph capture count
(``CompiledStep.captures``, observed as ``"decode_step"`` and
``"spec_round"``) and the kernel library's build count
(``kernels.build.BUILD_COUNT``, observed as ``"prefill"``: the prefill runs
eagerly, so what it can trigger is a build).  These are the port's
counterparts of the reference's jit cache sizes; on the CPU both stay 0.
It feeds the tracer's counter registry so the Prometheus exposition and
Chrome counters carry the same numbers."""
from __future__ import annotations

import dataclasses

from repro_torch.obs.tracer import NULL_TRACER


@dataclasses.dataclass
class PhaseStats:
    calls: int = 0
    wall_s: float = 0.0
    tokens: int = 0

    @property
    def tok_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0


class PhaseProfiler:
    """Per-phase wall/token accounting + recompile detection."""

    def __init__(self, tracer=NULL_TRACER):
        self.tracer = tracer
        self.phases: dict[str, PhaseStats] = {}
        self._cache_sizes: dict[str, int] = {}
        self.recompiles = 0

    def record(self, phase: str, dur_s: float, tokens: int = 0) -> None:
        st = self.phases.setdefault(phase, PhaseStats())
        st.calls += 1
        st.wall_s += dur_s
        st.tokens += tokens
        if self.tracer.enabled:
            self.tracer.inc(f"{phase}_calls")
            self.tracer.inc(f"{phase}_wall_ms", dur_s * 1e3)
            if tokens:
                self.tracer.inc(f"{phase}_tokens", tokens)

    def observe_cache(self, name: str, size: int | None) -> None:
        """Track a build or capture count; growth after the first sample is
        a recompile.  ``None`` (no such count) is a no-op."""
        if size is None:
            return
        prev = self._cache_sizes.get(name)
        self._cache_sizes[name] = size
        if prev is not None and size > prev:
            self.recompiles += size - prev
            if self.tracer.enabled:
                self.tracer.inc("recompiles", size - prev)
                self.tracer.emit("recompile", cause=name,
                                 sizes={"before": prev, "after": size})

    def snapshot(self) -> dict:
        return {
            "recompiles": self.recompiles,
            "phases": {
                name: {"calls": st.calls, "wall_s": st.wall_s,
                       "tokens": st.tokens, "tok_s": st.tok_s}
                for name, st in sorted(self.phases.items())},
        }

    def describe(self) -> str:
        parts = [
            f"{name}: {st.calls} calls {st.wall_s * 1e3:.1f}ms"
            + (f" {st.tokens} tok ({st.tok_s:.0f} tok/s)" if st.tokens else "")
            for name, st in sorted(self.phases.items())]
        parts.append(f"recompiles: {self.recompiles}")
        return " | ".join(parts)
