"""The nightly CI run (port of ``repro.core.ci``, paper §4.2.1): run the
measured suite in all four configurations (train/inference x with/without
donation), compare against the baseline store, file issues, and bisect.

Execution goes through the unified ``BenchmarkRunner``: pass a shared
runner to reuse arch builds and prepared steps across nights (the
per-night wall time drops to pure measurement after night 0).  A runner
this module creates runs on the card, as every entry point of the port
does unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.configs import ARCHS
from repro_torch.core.harness import RegressionHook
from repro_torch.core.regression import Issue, MetricStore, detect
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import ScenarioMatrix


@dataclasses.dataclass
class NightlyReport:
    ran: int
    issues: List[Issue]
    wall_s: float

    def to_dict(self) -> dict:
        return {"ran": self.ran, "wall_s": self.wall_s,
                "issues": [i.to_dict() for i in self.issues]}


def run_nightly(store: MetricStore, *, archs: Optional[List[str]] = None,
                tasks=("train", "infer_decode"), runs: int = 5,
                batches=(2,), seqs=(64,),
                update_baseline: bool = False,
                hooks: Optional[Dict[str, RegressionHook]] = None,
                runner: Optional[BenchmarkRunner] = None,
                jobs: Optional[int] = None) -> NightlyReport:
    """``jobs=N`` shards the night's matrix across N worker subprocesses
    (defaults to the runner's own ``jobs`` setting; the hooks' slowdown
    and leak ride in each job); the persistent pool keeps worker caches
    warm across repeated nights.  ``batches``/``seqs`` pick the probe
    cells — noisy shared hosts want small ones, so an injected regression
    dwarfs host jitter.

    Every measured result (ok or error, baseline night or not) is also
    appended to the store's history log as a time-series point
    (``MetricStore.log_result``) without touching the baseline pointer.
    A cell that comes back as an error (a refused train cell among them)
    is filed as a ``status`` issue carrying its error."""
    t0 = time.perf_counter()
    issues: List[Issue] = []
    owned = runner is None      # close what we create (shard workers!)
    runner = runner or BenchmarkRunner(runs=runs)
    matrix = ScenarioMatrix(archs=sorted(archs or ARCHS), tasks=tasks,
                            batches=batches, seqs=seqs)
    ran = 0
    try:
        for rr in runner.run_matrix(matrix, hooks=hooks, runs=runs, jobs=jobs):
            ran += 1
            store.log_result(rr)
            if rr.status != "ok":
                issues.append(Issue(benchmark=rr.bench, metric="status",
                                    baseline=0.0, observed=0.0, increase=0.0,
                                    culprit=rr.error))
                continue
            obs = rr.metrics()
            if update_baseline:
                store.update(rr.bench, obs)
            else:
                issues.extend(detect(store, rr.bench, obs))
    finally:
        if owned:
            runner.close()
    return NightlyReport(ran=ran, issues=issues,
                         wall_s=time.perf_counter() - t0)
