"""Process-wide metrics registry (a copy of ``repro.fleet.metrics``,
which imports no JAX; the port keeps its own copy and imports nothing of
the reference).

Counters, gauges, and bounded-reservoir histograms instrumenting the
hot *control* paths.  In the port these are the dispatchers:
``runner/pool.py`` (steals, respawns, worker deaths, queue depth) and
``runner/cluster/coordinator.py`` (steals, retires, heartbeat gaps,
queue depth, per-worker in-flight); the runner's per-result hook and the
serve engine's counters wait for the service layer (ROADMAP Queue 1,
item 12).  Every mutation is a dict update under one lock and happens
per cell / per job, never per decode step or per measured iteration;
``enabled = False`` turns every mutation into an early return.

Export surfaces:

* :meth:`MetricsRegistry.snapshot` — schema-tagged JSON
  (``{"fleet_metrics": 1, "counters": ..., "gauges": ...,
  "histograms": ...}``);
* :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  format (counters, gauges, and histograms as summaries with quantile
  labels).

Cross-process merging: worker subprocesses carry their own registry;
the flat cumulative-counter snapshot (:meth:`counters_cumulative`)
rides the JSONL result channel next to ``RunnerStats`` (the
``"metrics"`` field of a ``result`` message, see
``runner/protocol.py``) and the dispatcher delta-merges it with the
same ``protocol.stats_delta`` arithmetic — per-worker-process ``seen``
snapshots, reset on respawn — so parent-side counters stay
monotonically non-decreasing across worker respawns.  Histograms ship
only their count/sum on the wire (percentile reservoirs don't merge);
gauges are process-local and never cross.

This module depends only on the stdlib, so any layer can import it
without cycles.
"""
from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

METRICS_SCHEMA_KEY = "fleet_metrics"
METRICS_SCHEMA_VERSION = 1

#: bounded histogram reservoir — percentile estimates come from the most
#: recent RESERVOIR observations; count/sum stay exact forever
RESERVOIR = 256

#: separator for flat histogram encoding on the wire ("|" never appears
#: in metric names, see _NAME_OK)
_HIST_COUNT = "|hcount"
_HIST_SUM = "|hsum"

_NAME_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


class _Hist:
    __slots__ = ("count", "total", "vmax", "samples")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0
        self.samples: Deque[float] = deque(maxlen=RESERVOIR)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v
        self.samples.append(v)

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        vals = sorted(self.samples)
        idx = min(len(vals) - 1, int(math.ceil(q * len(vals))) - 1)
        return vals[max(0, idx)]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.total,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "max": self.vmax}


class MetricsRegistry:
    """Thread-safe counters / gauges / bounded-reservoir histograms.

    One process-wide instance lives behind :func:`registry`; tests build
    their own for isolation.  All mutation methods are near-no-ops when
    ``enabled`` is False.
    """

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Hist] = {}

    # ---- mutation --------------------------------------------------------

    def inc(self, name: str, value: float = 1.0) -> None:
        """Add to a monotonic counter (negative deltas are ignored —
        counters must survive ``stats_delta`` merging)."""
        if not self.enabled or value <= 0:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = _Hist()
            hist.observe(float(value))

    def reset(self) -> None:
        """Drop every instrument (tests / fresh service runs)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # ---- the runner's per-result hook ------------------------------------

    def record_result(self, rr: Any) -> None:
        """Count one scenario *execution* (a ``RunResult``): cells run /
        errored, executable-cache hit vs miss, and the compile/measure
        second distributions.  Called from the runner's result epilogue
        on every transport — note the measurement fence's unfenced warm
        pass is an execution too, so fenced cells count twice (the
        ledger-corrected ``RunnerStats`` stay the one-per-cell view)."""
        if not self.enabled:
            return
        self.inc("fleet_cells_total")
        if getattr(rr, "status", "ok") != "ok":
            self.inc("fleet_cells_errored_total")
            return
        cache = getattr(rr, "cache", None) or {}
        if cache.get("executable_reused"):
            self.inc("fleet_exec_cache_hits_total")
        else:
            self.inc("fleet_exec_cache_misses_total")
        compile_us = getattr(rr, "compile_us", 0.0) or 0.0
        if compile_us > 0:
            self.observe("fleet_compile_seconds", compile_us / 1e6)
        runs = getattr(rr, "runs", 0) or 0
        median_us = getattr(rr, "median_us", 0.0) or 0.0
        if runs and median_us:
            self.observe("fleet_measure_seconds", median_us * runs / 1e6)

    # ---- export ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Schema-tagged JSON snapshot (see ``runner/results.py``)."""
        with self._lock:
            return {
                METRICS_SCHEMA_KEY: METRICS_SCHEMA_VERSION,
                "ts": time.time(),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {n: h.summary()
                               for n, h in self._hists.items()},
            }

    def to_prometheus(self) -> str:
        """The Prometheus text exposition format: counters and gauges as
        single samples, histograms as summaries (quantile labels +
        ``_sum``/``_count``).  Names are sanitized to the Prometheus
        charset."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, v in sorted(snap["counters"].items()):
            n = _prom_name(name)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {_prom_num(v)}")
        for name, v in sorted(snap["gauges"].items()):
            n = _prom_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_prom_num(v)}")
        for name, h in sorted(snap["histograms"].items()):
            n = _prom_name(name)
            lines.append(f"# TYPE {n} summary")
            lines.append(f'{n}{{quantile="0.5"}} {_prom_num(h["p50"])}')
            lines.append(f'{n}{{quantile="0.95"}} {_prom_num(h["p95"])}')
            lines.append(f"{n}_sum {_prom_num(h['sum'])}")
            lines.append(f"{n}_count {_prom_num(h['count'])}")
        return "\n".join(lines) + "\n"

    # ---- the wire (worker -> dispatcher) ---------------------------------

    def counters_cumulative(self) -> Dict[str, float]:
        """Flat, monotonically non-decreasing snapshot for the JSONL
        result channel: counters verbatim plus each histogram's exact
        count/sum under ``<name>|hcount`` / ``<name>|hsum`` keys — the
        shape ``protocol.stats_delta`` can diff.  Gauges stay local."""
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
            for name, h in self._hists.items():
                out[name + _HIST_COUNT] = float(h.count)
                out[name + _HIST_SUM] = h.total
            return out

    def merge_cumulative(self, delta: Optional[Dict[str, float]]) -> None:
        """Fold a worker's ``stats_delta``-diffed snapshot into this
        registry.  Histogram count/sum merge exactly; the percentile
        reservoir only sees locally-observed samples (cross-process
        percentiles don't compose), so merged histograms report exact
        count/sum with parent-local quantiles."""
        if not delta or not self.enabled:
            return
        with self._lock:
            for k, v in delta.items():
                if not isinstance(v, (int, float)) or v <= 0:
                    continue
                if k.endswith(_HIST_COUNT):
                    hist = self._hists.setdefault(k[: -len(_HIST_COUNT)],
                                                  _Hist())
                    hist.count += int(v)
                elif k.endswith(_HIST_SUM):
                    hist = self._hists.setdefault(k[: -len(_HIST_SUM)],
                                                  _Hist())
                    hist.total += float(v)
                else:
                    self._counters[k] = self._counters.get(k, 0.0) + v


def _prom_name(name: str) -> str:
    name = _PROM_BAD.sub("_", name)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return name


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every instrumentation site writes to."""
    return _REGISTRY


def set_enabled(flag: bool) -> bool:
    """Toggle the process-wide registry; returns the previous state
    (for measuring the registry's own overhead both ways)."""
    prev = _REGISTRY.enabled
    _REGISTRY.enabled = bool(flag)
    return prev
