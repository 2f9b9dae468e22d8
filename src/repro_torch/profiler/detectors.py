"""Rule-based inefficiency detection over profiled RunResults (a copy of
``repro.profiler.detectors``; it imports the port's ``runner.latency``).

The paper's first use case is profiling the suite to *find* GPU
performance inefficiencies and drive optimization patches; these rules
are the measured-profile analogue of that optimization catalog.  Each
rule inspects RunResult dicts (the ``extra["prof_*"]`` payload plus the
serve / sharding extras) and emits ranked ``Finding``s:

    data_movement_bound    the cell's measured memory fraction dominates —
                           the classic fusion / layout / dtype patch target
    low_util               roofline utilization far below the sweep's
                           median — the cell leaves the most machine on
                           the table *relative to its peers* (absolute
                           utilization is host-dependent; the relative
                           comparison cancels host speed)
    compile_outlier        compile time a large multiple of the sweep's
                           median — guard-heavy or recompiling cells
    queue_saturation       serve cells whose arrival load sustainedly
                           exceeds the decode slots (queue_depth extras)
    shard_imbalance        sharded sweeps whose slowest shard dwarfs the
                           fastest — the LPT balance lost to a bad weight
                           guess or a straggler cell
    dispatch_bound         host dispatch overhead rivals device work —
                           batch-too-small / sync-heavy cells

Rules that need sweep context (low_util, compile_outlier,
shard_imbalance) compute it from the record batch they're given; single
records never fire them.  Thresholds live in one ``Thresholds`` config so
tests can pin them and future backends can recalibrate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.runner.latency import percentile

#: ranking order: crit first, then warn, then info
SEVERITIES = ("crit", "warn", "info")


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str           # "crit" | "warn" | "info"
    cell: str               # scenario name ("<sweep>" for cross-cell rules)
    summary: str
    score: float            # rule-specific magnitude, ranks within severity
    evidence: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Thresholds:
    #: memory fraction above which a cell is data-movement-bound
    memory_frac: float = 0.5
    #: escalate to crit above this memory fraction
    memory_frac_crit: float = 0.75
    #: fire low_util below this multiple of the sweep's median utilization
    util_rel: float = 0.33
    #: minimum profiled cells for the relative-utilization comparison
    util_min_cells: int = 3
    #: fire compile_outlier above this multiple of the median compile time
    compile_rel: float = 3.0
    #: ... but never below this absolute compile time (us)
    compile_min_us: float = 1e6
    #: serve: mean queue depth above slots * factor is saturation
    queue_factor: float = 1.0
    #: escalate to crit above slots * this factor
    queue_factor_crit: float = 2.0
    #: sharded sweeps: slowest/fastest shard wall ratio that fires
    shard_ratio: float = 1.5
    #: host dispatch fraction that rivals device work
    dispatch_frac: float = 0.35


def _ok(rec: dict) -> bool:
    return rec.get("status") == "ok"


def _extra(rec: dict) -> dict:
    return rec.get("extra") or {}


def _profiled(rec: dict) -> bool:
    return _ok(rec) and "prof_frac_memory" in _extra(rec)


def _median(vals: List[float]) -> float:
    """p50 via the shared percentile helper (one interpolation semantic
    across the whole codebase); call sites guarantee non-empty input."""
    return percentile(vals, 50)


# ---- per-cell rules --------------------------------------------------------

def _data_movement_bound(rec: dict, th: Thresholds) -> Optional[Finding]:
    e = _extra(rec)
    mem = e.get("prof_frac_memory", 0.0)
    if mem <= th.memory_frac or mem <= e.get("prof_frac_compute", 0.0):
        return None
    sev = "crit" if mem > th.memory_frac_crit else "warn"
    return Finding(
        rule="data_movement_bound", severity=sev, cell=rec["name"],
        summary=f"{mem:.0%} of measured time is data movement "
                f"(compute {e.get('prof_frac_compute', 0.0):.0%}) — "
                f"fusion/layout/dtype patch target",
        score=mem,
        evidence={"frac_memory": mem,
                  "frac_compute": e.get("prof_frac_compute", 0.0),
                  "class_frac": e.get("prof_class_frac", {})})


def _dispatch_bound(rec: dict, th: Thresholds) -> Optional[Finding]:
    e = _extra(rec)
    disp = e.get("prof_frac_dispatch", 0.0)
    if disp <= th.dispatch_frac:
        return None
    return Finding(
        rule="dispatch_bound", severity="warn", cell=rec["name"],
        summary=f"host dispatch is {disp:.0%} of measured time — "
                f"step too small or sync-heavy",
        score=disp,
        evidence={"frac_dispatch": disp,
                  "dispatch_us_mean": e.get("prof_dispatch_us_mean"),
                  "device_us_mean": e.get("prof_device_us_mean")})


def _queue_saturation(rec: dict, th: Thresholds) -> Optional[Finding]:
    if rec.get("task") != "serve" or not _ok(rec):
        return None
    e = _extra(rec)
    slots = e.get("slots") or 0
    qmean = e.get("queue_depth_mean")
    if not slots or qmean is None or qmean <= slots * th.queue_factor:
        return None
    sev = "crit" if qmean > slots * th.queue_factor_crit else "warn"
    return Finding(
        rule="queue_saturation", severity=sev, cell=rec["name"],
        summary=f"mean queue depth {qmean:.1f} exceeds {slots} decode "
                f"slots (max {e.get('queue_depth_max')}) — arrival load "
                f"saturates the batch",
        score=qmean / slots,
        evidence={"queue_depth_mean": qmean,
                  "queue_depth_max": e.get("queue_depth_max"),
                  "slots": slots, "trace": e.get("trace")})


# ---- sweep-context rules ---------------------------------------------------

def _low_util(records: List[dict], th: Thresholds) -> List[Finding]:
    utils = [(r, _extra(r)["prof_util"]) for r in records
             if _profiled(r) and _extra(r).get("prof_util", 0.0) > 0.0]
    if len(utils) < th.util_min_cells:
        return []
    med = _median([u for _, u in utils])
    out = []
    for rec, u in utils:
        if med <= 0.0 or u >= med * th.util_rel:
            continue
        out.append(Finding(
            rule="low_util", severity="warn", cell=rec["name"],
            summary=f"roofline utilization {u:.2e} is "
                    f"{u / med:.0%} of the sweep median ({med:.2e}) — "
                    f"the cell leaves the most machine idle",
            score=1.0 - u / med,
            evidence={"util": u, "sweep_median": med,
                      "bound_us": _extra(rec).get("prof_bound_us"),
                      "device_us_mean": _extra(rec).get("prof_device_us_mean")}))
    return out


def _compile_outliers(records: List[dict], th: Thresholds) -> List[Finding]:
    comp = [(r, r.get("compile_us", 0.0)) for r in records
            if _ok(r) and r.get("compile_us", 0.0) > 0.0]
    if len(comp) < 2:
        return []
    med = _median([c for _, c in comp])
    out = []
    for rec, c in comp:
        if med <= 0.0 or c <= max(med * th.compile_rel, th.compile_min_us):
            continue
        out.append(Finding(
            rule="compile_outlier", severity="info", cell=rec["name"],
            summary=f"compile time {c / 1e6:.1f}s is {c / med:.1f}x the "
                    f"sweep median ({med / 1e6:.1f}s)",
            score=c / med,
            evidence={"compile_us": c, "sweep_median_us": med}))
    return out


def _shard_imbalance(records: List[dict], th: Thresholds) -> List[Finding]:
    walls: Dict[int, float] = {}
    for r in records:
        shard = _extra(r).get("shard")
        if shard is None or not _ok(r):
            continue
        walls[shard] = walls.get(shard, 0.0) + (r.get("wall_s") or 0.0)
    if len(walls) < 2:
        return []
    slow, fast = max(walls.values()), min(walls.values())
    if fast <= 0.0 or slow / fast <= th.shard_ratio:
        return []
    return [Finding(
        rule="shard_imbalance", severity="info", cell="<sweep>",
        summary=f"slowest shard ran {slow:.1f}s vs fastest {fast:.1f}s "
                f"({slow / fast:.1f}x) over {len(walls)} shards — "
                f"rebalance weights or steal work",
        score=slow / fast,
        evidence={"shard_wall_s": {str(k): round(v, 2)
                                   for k, v in sorted(walls.items())}})]


def detect(records: Iterable[dict],
           th: Optional[Thresholds] = None) -> List[Finding]:
    """Run every rule over a batch of RunResult dicts; returns findings
    ranked most-severe first (severity order, then score descending)."""
    th = th or Thresholds()
    recs = [r.to_dict() if hasattr(r, "to_dict") else dict(r)
            for r in records]
    findings: List[Finding] = []
    for rec in recs:
        if _profiled(rec):
            for rule in (_data_movement_bound, _dispatch_bound):
                f = rule(rec, th)
                if f:
                    findings.append(f)
        f = _queue_saturation(rec, th)
        if f:
            findings.append(f)
    findings += _low_util(recs, th)
    findings += _compile_outliers(recs, th)
    findings += _shard_imbalance(recs, th)
    findings.sort(key=lambda f: (SEVERITIES.index(f.severity), -f.score))
    return findings
