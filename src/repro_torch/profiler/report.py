"""Findings report: ranked inefficiency findings with evidence, as JSON
and as a human table (a copy of ``repro.profiler.report``; the port's
surface so far is ``chip_smoke.py``'s ``profile_report`` line)."""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from repro_torch.profiler.detectors import SEVERITIES, Finding

REPORT_SCHEMA = 1


def build_report(records: Iterable[dict], findings: List[Finding], *,
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One JSON-able report over a profiled sweep.  ``findings`` are
    assumed ranked (``detectors.detect`` ranks); the report preserves
    their order and adds per-rule / per-severity tallies."""
    recs = [r.to_dict() if hasattr(r, "to_dict") else dict(r)
            for r in records]
    ok = [r for r in recs if r.get("status") == "ok"]
    profiled = [r for r in ok
                if "prof_frac_memory" in (r.get("extra") or {})]
    by_rule: Dict[str, int] = {}
    by_severity = {s: 0 for s in SEVERITIES}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        by_severity[f.severity] = by_severity.get(f.severity, 0) + 1
    return {
        "schema": REPORT_SCHEMA,
        "meta": dict(meta or {}),
        "cells": len(recs),
        "cells_ok": len(ok),
        "cells_profiled": len(profiled),
        "by_rule": by_rule,
        "by_severity": by_severity,
        "findings": [f.to_dict() for f in findings],
    }


def format_table(report: Dict[str, Any], *, max_rows: int = 40) -> str:
    """The report as fixed-width text lines (severity, rule, cell,
    summary), most severe first."""
    lines = [f"profiled {report['cells_profiled']}/{report['cells']} cells "
             f"-> {len(report['findings'])} findings "
             f"(crit={report['by_severity'].get('crit', 0)} "
             f"warn={report['by_severity'].get('warn', 0)} "
             f"info={report['by_severity'].get('info', 0)})"]
    for f in report["findings"][:max_rows]:
        lines.append(f"  {f['severity']:<4} {f['rule']:<20} "
                     f"{f['cell']:<44} {f['summary']}")
    dropped = len(report["findings"]) - max_rows
    if dropped > 0:
        lines.append(f"  ... {dropped} more findings (see JSON)")
    return "\n".join(lines)
