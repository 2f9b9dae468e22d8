"""Benchmark execution: scenario matrix -> runner -> store (serial subset).

    Scenario, ScenarioMatrix     declarative execution matrix
    BenchmarkRunner, RunnerStats execution + build/executable reuse
    RunResult, ResultStore       versioned records, JSONL log + latest pointer
    TraceSpec, generate_trace    deterministic serving load profiles
    percentile, latency_summary  shared latency-distribution helpers
"""
from repro_torch.runner.latency import latency_summary, percentile
from repro_torch.runner.results import SCHEMA_VERSION, ResultStore, RunResult
from repro_torch.runner.runner import BenchmarkRunner, RunnerStats
from repro_torch.runner.scenario import (MODES, SERVE_MODES, STEP_TASKS, TASKS,
                                         Scenario, ScenarioMatrix)
from repro_torch.runner.traces import (PROFILES, Request, TraceSpec, load_spec,
                                       save_spec)
from repro_torch.runner.traces import generate as generate_trace

__all__ = ["Scenario", "ScenarioMatrix", "MODES", "SERVE_MODES", "TASKS",
           "STEP_TASKS", "BenchmarkRunner", "RunnerStats", "RunResult",
           "ResultStore", "SCHEMA_VERSION", "PROFILES", "Request", "TraceSpec",
           "generate_trace", "save_spec", "load_spec", "percentile",
           "latency_summary"]
