"""Measured profiling subsystem: where did a benchmark cell's time go?
(port of ``repro.profiler``)

Four layers, all flowing through the BenchmarkRunner
(``runner.run(..., profile=True)``):

    timeline     per-step phase capture: exposed host time vs the
                 device's busy time per step (from a kernel trace of
                 extra, untimed steps); per-decode-step timelines for
                 serve cells; the card's memory stats
    attribution  merge the measured timeline with the eager step's
                 op-class costs (``core.hloanalysis``) and the trace's
                 measured class times into matmul/attention/collective/
                 elementwise/other shares and compute/memory/collective/
                 dispatch/idle fractions that sum to 1.0
    detectors    rule-based inefficiency findings: data-movement-bound,
                 low relative utilization, compile outliers, serve queue
                 saturation, shard imbalance, dispatch-bound (a copy)
    report       ranked findings with severity + evidence, JSON + table
                 (a copy)

The profile lands under the well-known ``extra["prof_*"]`` keys
documented in ``repro_torch/runner/results.py`` (schema stays v1).
"""
from repro_torch.profiler.attribution import (Attribution, attribute, class_times,
                                              profile_extra, trace_device_time)
from repro_torch.profiler.detectors import Finding, Thresholds, detect
from repro_torch.profiler.report import build_report, format_table
from repro_torch.profiler.timeline import (TIMELINE_CAP, PhaseSample, Timeline,
                                           device_memory_stats)

__all__ = ["Timeline", "PhaseSample", "TIMELINE_CAP", "device_memory_stats",
           "Attribution", "attribute", "class_times",
           "trace_device_time", "profile_extra",
           "Finding", "Thresholds", "detect",
           "build_report", "format_table"]
