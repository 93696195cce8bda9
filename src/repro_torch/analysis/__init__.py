"""repro_torch.analysis — static verification of the run-time-precision
contracts on the port, as the reference's ``repro.analysis``.

Three passes, run together by ``python -m repro_torch.analysis``:

* :mod:`repro_torch.analysis.flow` — precision-flow checking over a step's
  recorded ops (FLOW-F64 / FLOW-WIDEN / FLOW-MODE / FLOW-NARROW).
* :mod:`repro_torch.analysis.dispatch` — dispatch audit with declarative
  per-hot-path expectations (DISP-COUNT / DISP-DENSIFY).
* :mod:`repro_torch.analysis.lint` — capture-hygiene AST linter over
  ``src/repro_torch`` (TH001–TH005).

The first two read one record: the ops a step dispatches, taken by
``launch.op_cost.record_ops`` (the ``TorchDispatchMode`` of
``repro_torch.oprecord``), with the hand kernels charged by their
wrappers.  The hot paths themselves live in
:mod:`repro_torch.analysis.hotpaths`; results are
:class:`~repro_torch.analysis.report.Violation` records.
"""
from repro_torch.analysis.dispatch import (
    Expect,
    audit,
    audit_events,
    audit_stats,
    dispatch_stats,
)
from repro_torch.analysis.flow import MANTISSA_BITS, analyze_flow, flow_violations
from repro_torch.analysis.lint import (
    ALLOWLIST,
    RULES,
    lint_file,
    lint_paths,
    lint_source,
)
from repro_torch.analysis.report import Violation, format_report, rule_ids, write_json

__all__ = [
    "ALLOWLIST",
    "Expect",
    "MANTISSA_BITS",
    "RULES",
    "Violation",
    "analyze_flow",
    "audit",
    "audit_events",
    "audit_stats",
    "dispatch_stats",
    "flow_violations",
    "format_report",
    "lint_file",
    "lint_paths",
    "lint_source",
    "rule_ids",
    "write_json",
]
