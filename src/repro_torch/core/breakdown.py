"""Execution-time breakdown (port of ``repro.core.breakdown``; paper
Figs. 1-2 / Table 2 analogue).

TorchBench decomposes wall time into GPU-active / data-movement / idle with
a profiler.  Two sources feed the same row/table shape here, each row
labeled with its provenance so mixed tables stay unambiguous:

* ``source="measured"`` — the measured profiler
  (``src/repro_torch/profiler/``): per-cell phase timelines + op-class
  attribution recorded by a profiled runner sweep.  Fractions are of
  *measured* step time and include the dispatch/idle shares the analytic
  model cannot see.
* ``source="analytic"`` — the roofline estimate of a step:

      busy fraction     = compute_s / step_upper         (tensor cores busy)
      data movement     = memory_s / step_upper          (HBM-bound exposure)
      idle (comm-bound) = collective_s / step_upper      (link wait)

  The reference takes these from its dry-run tier's cells; the port has
  no dry-run tier yet (ROADMAP item 14), so ``analytic_cells`` makes cells
  of the same layout from ``roofline_from_cost(analyze_step(...))`` at the
  runner's shapes (one card).

Both aggregate per domain exactly like the paper's Table 2.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterable, List

from repro_torch.configs import ARCHS
from repro_torch.device import DeviceLike

# the runner's tasks as the roofline's shape kinds
_KIND = {"train": "train", "infer_prefill": "prefill", "infer_decode": "decode"}


def breakdown_rows(dryrun_results: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Analytic rows from cells carrying a ``roofline`` (roofline-term
    fractions)."""
    rows = []
    for r in dryrun_results:
        if "roofline" not in r:
            continue
        rl = r["roofline"]
        total = rl["compute_s"] + rl["memory_s"] + rl["collective_s"]
        if not total:
            continue
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r.get("mesh", ""),
            "domain": ARCHS[r["arch"]].domain if r["arch"] in ARCHS else "?",
            "compute_frac": rl["compute_s"] / total,
            "memory_frac": rl["memory_s"] / total,
            "collective_frac": rl["collective_s"] / total,
            "dominant": rl["dominant"],
            "source": "analytic",
        })
    return rows


def analytic_cells(benches: Iterable[Any], *, batch: int = 2, seq: int = 64,
                   runner: Any = None, device: DeviceLike = "cuda"
                   ) -> List[Dict[str, Any]]:
    """One cell ``{"arch", "shape", "mesh", "chips", "cell", "roofline"}``
    per suite ``Benchmark``: its step at (batch, seq) run once, untimed,
    under ``analyze_step`` (the step's state restored after it), then
    ``roofline_from_cost`` on one card.  ``shape`` holds the task, as on
    measured rows.  ``runner`` lends its cached builds and its device."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.hloanalysis import analyze_step
    from repro_torch.core.roofline import model_flops_estimate, roofline_from_cost
    from repro_torch.core.suite import build_arch
    out = []
    for b in benches:
        built = (runner.built_for(b.arch) if runner is not None
                 else build_arch(b.arch, device=device))
        step, args, donate = b.make(batch=batch, seq=seq, built=built)
        cost = analyze_step(step, args, donate)
        shape = ShapeConfig(f"b{batch}_s{seq}", seq, batch, _KIND[b.task])
        rl = roofline_from_cost(cost, arch=b.arch, shape=b.task, mesh="1", chips=1,
                                model_flops=model_flops_estimate(built.cfg, shape))
        out.append({"arch": b.arch, "shape": b.task, "mesh": "1", "chips": 1,
                    "cell": f"{b.name}/b{batch}/s{seq}", "roofline": rl.to_dict()})
    return out


def measured_breakdown_rows(results: Iterable[Any]) -> List[Dict[str, Any]]:
    """Measured rows from profiled RunResults (dicts or RunResult objects).

    Same row shape as ``breakdown_rows`` — ``shape`` holds the task so the
    train/inference split works — plus the measured-only ``dispatch_frac``
    / ``idle_frac`` columns (the three roofline fractions deliberately do
    NOT sum to 1 on measured rows: the remainder is measured overhead).
    Cells without a profile (errors, unprofiled) are skipped."""
    rows = []
    for r in results:
        rec = r.to_dict() if hasattr(r, "to_dict") else dict(r)
        extra = rec.get("extra") or {}
        if rec.get("status") != "ok" or "prof_frac_compute" not in extra:
            continue
        fracs = {
            "compute": extra["prof_frac_compute"],
            "memory": extra["prof_frac_memory"],
            "collective": extra["prof_frac_collective"],
            "dispatch": extra["prof_frac_dispatch"],
            "idle": extra["prof_frac_idle"],
        }
        rows.append({
            "arch": rec["arch"], "shape": rec["task"], "mesh": "host",
            "domain": ARCHS[rec["arch"]].domain if rec["arch"] in ARCHS else "?",
            "compute_frac": fracs["compute"],
            "memory_frac": fracs["memory"],
            "collective_frac": fracs["collective"],
            "dispatch_frac": fracs["dispatch"],
            "idle_frac": fracs["idle"],
            "dominant": max(fracs, key=fracs.get),
            "source": "measured",
            "cell": rec["name"],
        })
    return rows


def domain_table(rows: List[Dict[str, Any]], kind_filter=None) -> List[Dict[str, Any]]:
    acc: Dict[str, List[Dict]] = defaultdict(list)
    for r in rows:
        if kind_filter and not kind_filter(r):
            continue
        acc[r["domain"]].append(r)
    out = []
    for dom, rs in sorted(acc.items()):
        out.append({
            "domain": dom,
            "n": len(rs),
            "compute_frac": sum(r["compute_frac"] for r in rs) / len(rs),
            "memory_frac": sum(r["memory_frac"] for r in rs) / len(rs),
            "collective_frac": sum(r["collective_frac"] for r in rs) / len(rs),
        })
    return out
