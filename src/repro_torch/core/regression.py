"""Performance-regression detection and bisection (port of
``repro.core.regression``, paper §4.2).

Mirrors the PyTorch-CI integration TorchBench shipped:

* ``MetricStore`` — per-benchmark baseline metrics (execution time +
  host/device memory).  A thin view over
  ``repro_torch.runner.results.ResultStore``, whose files are the
  reference's: the baseline map is the store's latest pointer (one JSON
  file) and every ``update`` is also appended to the sibling ``*.jsonl``
  run log, so a store written by either package reads the same in the
  other.
* ``detect`` — flags any benchmark whose metric exceeds baseline by the
  paper's 7% threshold; emits a structured "GitHub issue" record.
* ``bisect_commits`` — the paper's nightly strategy: check only the nightly
  build; if it regressed, binary-search the day's commits by timestamp.
  Commits are modeled as objects with a ``run(benchmark) -> metrics``
  callable so tests can inject real measured regressions.

On the card a host-bound cell's median moves by more than 7% between
clean runs (``PERF.md``, the ``noise`` phase of ``chip_smoke.py``);
``THRESHOLD`` stays the reference's, and a caller who knows a cell's
spread passes its own ``threshold``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

THRESHOLD = 0.07   # the paper's 7%

METRICS = ("median_us", "host_peak_bytes", "device_bytes_delta")


@dataclasses.dataclass
class Issue:
    benchmark: str
    metric: str
    baseline: float
    observed: float
    increase: float
    culprit: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_NON_METRIC_KEYS = ("name", "ts", "schema")


class MetricStore:
    def __init__(self, path: str):
        from repro_torch.runner.results import ResultStore
        self.path = path
        self._store = ResultStore(path)

    @property
    def data(self) -> Dict[str, Dict[str, float]]:
        return {name: self._metrics(rec)
                for name, rec in self._store.latest.items()}

    @staticmethod
    def _metrics(rec: Dict[str, Any]) -> Dict[str, float]:
        return {k: v for k, v in rec.items() if k not in _NON_METRIC_KEYS}

    def update(self, benchmark: str, metrics: Dict[str, float]) -> None:
        self._store.append({"name": benchmark,
                            **{k: float(v) for k, v in metrics.items()}})

    def baseline(self, benchmark: str) -> Optional[Dict[str, float]]:
        rec = self._store.latest.get(benchmark)
        return None if rec is None else self._metrics(rec)

    def history(self, benchmark: str):
        """Replay every baseline this benchmark ever recorded (JSONL log)."""
        return self._store.history(benchmark)

    def log_result(self, result) -> dict:
        """Append one full ``RunResult`` to the history log WITHOUT moving
        the latest pointer: a time-series point, not a new baseline —
        ``data``/``baseline`` views stay exactly what ``update`` last
        wrote."""
        return self._store.append(result, advance_latest=False)


def detect(store: MetricStore, benchmark: str, observed: Dict[str, float],
           *, threshold: float = THRESHOLD,
           metrics: Sequence[str] = METRICS) -> List[Issue]:
    base = store.baseline(benchmark)
    if base is None:
        return []
    issues = []
    for m in metrics:
        b = base.get(m)
        o = observed.get(m)
        if not b or o is None or b <= 0:
            continue
        inc = (o - b) / b
        if inc > threshold:
            issues.append(Issue(benchmark=benchmark, metric=m, baseline=b,
                                observed=o, increase=inc))
    return issues


@dataclasses.dataclass
class Commit:
    sha: str
    timestamp: int
    run: Callable[[str], Dict[str, float]]   # benchmark name -> metrics


def bisect_commits(commits: Sequence[Commit], benchmark: str, metric: str,
                   baseline: float, *, threshold: float = THRESHOLD,
                   trace: Optional[List[str]] = None) -> Optional[Commit]:
    """Binary-search the first commit whose metric regresses past threshold.

    Precondition (the nightly check): the last commit is known-regressed.
    Returns the culprit commit, measuring O(log n) commits.
    """
    commits = sorted(commits, key=lambda c: c.timestamp)
    lo, hi = 0, len(commits) - 1

    def bad(i: int) -> bool:
        obs = commits[i].run(benchmark)[metric]
        is_bad = (obs - baseline) / baseline > threshold
        if trace is not None:
            trace.append(f"measure {commits[i].sha}: {obs:.1f} ({'bad' if is_bad else 'good'})")
        return is_bad

    if not bad(hi):
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        if bad(mid):
            hi = mid
        else:
            lo = mid + 1
    return commits[lo]
