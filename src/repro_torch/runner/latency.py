"""Shared latency-distribution helpers for serving metrics.

A copy of ``repro.runner.latency`` (pure Python), kept in the port so the
port imports nothing of the reference.

Production users compare serving systems by latency *distributions* —
TTFT and per-token p50/p95/p99 — not mean step time (paper §2.2 framing;
the inference-framework comparisons in PAPERS.md all report tails).  This
module is the one place those percentiles are computed, so the serve
engine, the runner's RunResult extras, and the benchmark tables can never
disagree on interpolation semantics.

``percentile`` uses linear interpolation between closest ranks (the
numpy default), implemented in plain Python so it is trivially auditable
and exact for the small sample counts a serve cell produces.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

#: the quantiles every latency summary reports (p50/p95/p99)
QUANTILES = (50.0, 95.0, 99.0)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values``, linear interpolation.

    Handles any sample count >= 1: a single sample is every percentile of
    itself; even counts interpolate between the two middle ranks for p50.
    Raises ``ValueError`` on an empty sample or ``q`` outside [0, 100].
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of an empty sample")
    if len(vals) == 1:
        return vals[0]
    rank = (q / 100.0) * (len(vals) - 1)
    lo = int(rank)
    frac = rank - lo
    if frac == 0.0 or lo + 1 >= len(vals):
        return vals[lo]
    return vals[lo] * (1.0 - frac) + vals[lo + 1] * frac


def latency_summary(values: Iterable[float], prefix: str,
                    scale: float = 1.0) -> Dict[str, float]:
    """p50/p95/p99 of ``values`` as ``{prefix}_p50`` ... keys.

    ``scale`` converts units on the way out (e.g. ``1e6`` seconds -> us).
    Empty samples produce an empty dict — callers treat the keys as
    optional, matching the RunResult extra-key contract.
    """
    vals: List[float] = [float(v) * scale for v in values]
    if not vals:
        return {}
    return {f"{prefix}_p{int(q)}": percentile(vals, q) for q in QUANTILES}
