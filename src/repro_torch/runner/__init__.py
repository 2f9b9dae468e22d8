"""Benchmark execution: scenario matrix -> runner -> store.

    Scenario, ScenarioMatrix      declarative execution matrix
    BenchmarkRunner, RunnerStats  execution + build/step reuse + isolation
    ShardScheduler, assign_shards sharded process-pool dispatch (jobs=N)
    Coordinator, ClusterScheduler cluster dispatch (cluster=...)
    RunResult, ResultStore        versioned records, JSONL log + latest pointer
    TraceSpec, generate_trace     deterministic serving load profiles
    percentile, latency_summary   shared latency-distribution helpers
"""
from repro_torch.runner.cluster import (ClusterScheduler, Coordinator,
                                        parse_cluster_spec)
from repro_torch.runner.latency import latency_summary, percentile
from repro_torch.runner.pool import ShardScheduler, assign_shards, rank_groups
from repro_torch.runner.results import SCHEMA_VERSION, ResultStore, RunResult
from repro_torch.runner.runner import BenchmarkRunner, RunnerStats
from repro_torch.runner.scenario import (MODES, SERVE_MODES, STEP_TASKS, TASKS,
                                         Scenario, ScenarioMatrix)
from repro_torch.runner.traces import (PROFILES, Request, TraceSpec, load_spec,
                                       save_spec)
from repro_torch.runner.traces import generate as generate_trace

__all__ = ["Scenario", "ScenarioMatrix", "MODES", "SERVE_MODES", "TASKS",
           "STEP_TASKS", "BenchmarkRunner", "RunnerStats", "ShardScheduler",
           "assign_shards", "rank_groups", "Coordinator", "ClusterScheduler",
           "parse_cluster_spec", "RunResult", "ResultStore", "SCHEMA_VERSION",
           "PROFILES", "Request", "TraceSpec", "generate_trace", "save_spec",
           "load_spec", "percentile", "latency_summary"]
