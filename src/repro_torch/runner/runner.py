"""The BenchmarkRunner (port of ``repro.runner.runner``).

* resolves ``Scenario``s against the suite registry (``core.suite``);
* reuses expensive state across scenarios: arch builds (config + model on
  the device) per (arch, dtype, mode-overrides), prepared steps with their
  threaded arguments per scenario, serve engines per (build, mode,
  max_len, admission), and profiled cells' op-class costs per scenario
  (and per serve engine);
* runs a cell in this process, or in its own subprocess
  (``isolate=True``: a crash becomes an error record), and a matrix
  serially, across N persistent shard workers (``jobs=N``, with work
  stealing and the measurement fence; ``runner/pool.py``) or across
  socket-connected workers (``cluster="local:N"`` or ``"HOST:PORT"``;
  ``runner/cluster/``), every worker on this runner's device;
* emits one schema-v1 ``RunResult`` per execution into a ``ResultStore``,
  stamped ``extra["prov_framework"]="torch"`` and ``extra["prov_device"]``
  (``stamp``, also on the error records the dispatchers make);
* profiles a cell when asked (``profile=True`` on the runner, per
  ``run`` or per ``run_matrix``): the measured phase timeline and its
  op-class attribution under ``extra["prof_*"]`` (``repro_torch.profiler``);
* annotates serial, in-process step cells with their API-surface coverage
  when asked (``coverage=True``): ``extra["cov_*"]`` (``core/coverage``).

Runs ``train``, ``infer_prefill``, ``infer_decode``, ``serve`` and
``loadgen`` cells in every compiler mode (see ``scenario.py`` for the
mapping): a step cell in a ``jit*`` mode measures ``harness.compile_step``
of its step (compiled once per scenario, in the process that runs the
cell: Dynamo's cache is per process, while a graph another process
compiled loads from Inductor's disk cache, which the workers share through
``harness.compile_env``), an ``eager`` cell the step
itself (``harness.measure_eager``); serve and loadgen cells replay their
trace through a ``ServeEngine`` whose decode step and admission are
compiled.  ``kernel`` cells come back as error records naming the
ROADMAP item.  Not ported yet, and raising ``NotImplementedError`` when
asked for: span tracing (ROADMAP Queue 1, item 12) and the dry-run tier
(item 14).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.harness import (RegressionHook, compile_budget, compile_step,
                                     measure, measure_eager, prepare)
from repro_torch.core.hloanalysis import HloCost, analyze_step
from repro_torch.core.suite import Built, build_arch, get_benchmark
from repro_torch.device import DeviceLike, device_name, resolve_device
from repro_torch.fleet.metrics import registry as metrics_registry
from repro_torch.profiler.attribution import profile_extra
from repro_torch.runner.latency import percentile
from repro_torch.runner.pool import ShardScheduler, _subprocess_env
from repro_torch.runner.results import ResultStore, RunResult
from repro_torch.runner.scenario import Scenario, ScenarioMatrix
from repro_torch.runner.traces import (cache_len_bound, capture_spec,
                                       spec_for_scenario)
from repro_torch.runner.traces import generate as generate_trace

_MEASURE = "(ROADMAP Queue 1, item 11: the kernel autotuner's cells)"


def _unported(**flags) -> None:
    """Raise for the first runner feature asked for that is not ported."""
    where = {"tracer": "(ROADMAP Queue 1, slice 7, item 12: span tracing)"}
    for name, asked in flags.items():
        if asked:
            raise NotImplementedError(f"BenchmarkRunner {name}= is not "
                                      f"ported yet {where[name]}")


def stamp(rr: RunResult, device: DeviceLike) -> RunResult:
    """Stamp the port's provenance on a record: which package measured it
    and on which device.  ``setdefault``: a record a worker stamped keeps
    its own values; the dispatchers' error records get the dispatcher's
    device, which its workers share."""
    rr.extra.setdefault("prov_framework", "torch")
    rr.extra.setdefault("prov_device", device_name(device))
    return rr


@dataclasses.dataclass
class RunnerStats:
    model_builds: int = 0
    model_cache_hits: int = 0
    executable_builds: int = 0
    executable_cache_hits: int = 0
    scenarios_run: int = 0
    errors: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def merge(self, other) -> "RunnerStats":
        """Field-wise add another stats snapshot (RunnerStats or dict) —
        how worker-subprocess counts become visible in the parent."""
        d = other.to_dict() if isinstance(other, RunnerStats) else dict(other or {})
        for f in dataclasses.fields(self):
            if d.get(f.name):
                setattr(self, f.name, getattr(self, f.name) + int(d[f.name]))
        return self


@dataclasses.dataclass
class _ExecEntry:
    jitted: Callable                # the prepared (compiled, but for eager) step
    step: Callable                  # the uncompiled step
    args: Tuple                     # threaded, donation-valid arguments
    donate: Tuple[int, ...]
    mutable: Tuple[int, ...]        # the slots the step updates in place


class BenchmarkRunner:
    def __init__(self, store: Optional[ResultStore] = None, *,
                 runs: int = 5, warmup: int = 1, compile_warmup: int = 3,
                 reuse: bool = True, device: DeviceLike = "cuda",
                 isolate: bool = False, jobs: int = 0,
                 measure_fence: bool = True, profile: bool = False,
                 cluster: str = "", steal: bool = True, tracer: Any = None,
                 coverage: bool = False):
        _unported(tracer=tracer is not None)
        # before anything is spawned: a card asked for and absent raises
        # here, and every worker runs on this device
        self.device = resolve_device(device)
        self.store = store
        self.runs = runs
        self.warmup = warmup
        # extra warmup steps after a fresh build: the first calls run well
        # above steady state (allocator growth, library handles)
        self.compile_warmup = compile_warmup
        self.reuse = reuse
        self.isolate = isolate
        # default shard count for run_matrix; <=1 means the serial
        # in-process path.  measure_fence serializes the workers' device
        # work (on a card: every launch of a cell; on the CPU: the timed
        # loops; see worker._run_cell); throughput-only sweeps may turn it off
        self.jobs = jobs
        self.measure_fence = measure_fence
        # default cluster spec for run_matrix: "local:N" spawns N localhost
        # socket workers, "HOST:PORT" binds the coordinator there for
        # workers launched elsewhere (runner/cluster/); "" means none.
        # steal picks dynamic group stealing vs static LPT for the pool
        self.cluster = cluster
        self.steal = steal
        # measured profiling (repro_torch/profiler/): per-step phase
        # timelines + op-class attribution under extra["prof_*"]; per-call
        # override via run(..., profile=...)
        self.profile = profile
        # API-surface coverage annotations (opt-in, serial in-process step
        # cells only): run each scenario's step once through
        # core.coverage.step_surfaces and attach extra["cov_*"] counts; the
        # process-wide union feeds the metrics-registry gauge.  The pass is
        # cached per scenario, so re-measures pay nothing.
        self.coverage = coverage
        self._cov_cache: Dict[Scenario, frozenset] = {}
        self._cov_union: set = set()
        self.stats = RunnerStats()
        self._built: Dict[Tuple, Built] = {}
        self._execs: Dict[Scenario, _ExecEntry] = {}
        self._serve_engines: Dict[Tuple, Any] = {}
        self._prof_costs: Dict[Any, HloCost] = {}
        self._pool: Optional[ShardScheduler] = None
        self._cluster: Optional[Any] = None   # ClusterScheduler, lazy

    def close(self) -> None:
        """Shut down the persistent shard workers and the cluster
        coordinator + its local workers (no-op when serial)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None
        if self._cluster is not None:
            self._cluster.close()
            self._cluster = None

    def cluster_worker_pids(self) -> List[int]:
        """PIDs of the locally-spawned cluster workers (``cluster=
        "local:N"``), empty when no cluster is active or it binds for
        external workers."""
        return [] if self._cluster is None else self._cluster.worker_pids()

    def worker_pids(self) -> List[int]:
        """PIDs of every worker subprocess this runner has live — the
        shard pool plus local cluster workers.  The no-orphans gate:
        after ``close()`` this is empty and each earlier PID is dead."""
        pids: List[int] = []
        if self._pool is not None:
            pids.extend(self._pool.worker_pids())
        pids.extend(self.cluster_worker_pids())
        return pids

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ---- build / executable caches -------------------------------------

    def built_for(self, arch: str, *, dtype: str = "fp32",
                  mode: str = "jit_donated") -> Built:
        """The cached arch build for (arch, dtype, mode-overrides)."""
        sc = Scenario(arch=arch, dtype=dtype, mode=mode)
        key = sc.build_key()
        if key in self._built:
            self.stats.model_cache_hits += 1
            return self._built[key]
        built = build_arch(arch, sc.build_overrides(), self.device)
        self.stats.model_builds += 1
        if self.reuse:
            self._built[key] = built
        return built

    def _resolve(self, scenario: Scenario) -> Tuple[_ExecEntry, Dict[str, bool]]:
        if self.reuse and scenario in self._execs:
            self.stats.executable_cache_hits += 1
            return self._execs[scenario], {"model_reused": True,
                                           "executable_reused": True}
        hits0 = self.stats.model_cache_hits
        built = self.built_for(scenario.arch, dtype=scenario.dtype,
                               mode=scenario.mode)
        bench = get_benchmark(scenario.arch, scenario.task)
        step, args, donate = bench.make(batch=scenario.batch, seq=scenario.seq,
                                        built=built)
        if scenario.mode == "eager":
            # no compiled callable: every call copies what the step updates
            entry = _ExecEntry(jitted=prepare(step, (), mutable=donate), step=step,
                               args=args, donate=(), mutable=donate)
        else:
            d = donate if scenario.mode == "jit_donated" else ()
            # the copies of prepare() lie outside the compiled region
            entry = _ExecEntry(jitted=prepare(compile_step(step, self.device), d,
                                              mutable=donate),
                               step=step, args=args, donate=d, mutable=donate)
            self.stats.executable_builds += 1
        if self.reuse:
            self._execs[scenario] = entry
        return entry, {"model_reused": self.stats.model_cache_hits > hits0,
                       "executable_reused": False}

    # ---- measured path --------------------------------------------------

    def run(self, scenario: Scenario, *, hook: Optional[RegressionHook] = None,
            runs: Optional[int] = None, warmup: Optional[int] = None,
            record: bool = True, profile: Optional[bool] = None,
            extra: Optional[Dict[str, Any]] = None) -> RunResult:
        """Execute one scenario and return its RunResult (benchmark failures
        come back as status="error" records, they are not raised).

        ``task="serve"`` cells run the continuous-batching engine over the
        scenario's trace instead of the ``measure()`` step protocol.

        ``profile`` (default: the runner's ``profile`` setting) splits each
        measured step into exposed host time and the device's busy time
        (``harness.measure(phase_log=...)``), and attributes the device
        time over op classes (``repro_torch.profiler``); the profile lands
        under ``extra["prof_*"]``.  Its trace and cost pass run outside
        the timed loop.
        """
        prof = self.profile if profile is None else profile
        if scenario.task == "kernel":
            self.stats.scenarios_run += 1
            self.stats.errors += 1
            return self._finalize(RunResult.from_error(
                scenario, f"NotImplementedError: task={scenario.task!r} is not "
                          f"ported yet {_MEASURE}", wall_s=0.0), extra, record)
        if self.isolate:
            return self._run_isolated(scenario, hook=hook, runs=runs,
                                      warmup=warmup, record=record,
                                      profile=prof, extra=extra)
        if scenario.task in ("serve", "loadgen"):
            return self._run_serve(scenario, hook=hook, record=record,
                                   profile=prof, extra=extra)
        t0 = time.perf_counter()
        self.stats.scenarios_run += 1
        try:
            entry, cache = self._resolve(scenario)
            # before the measure, which threads the donated state on
            cov = self._coverage_extra(scenario, entry) if self.coverage else None
            if scenario.mode == "eager":
                m = measure_eager(scenario.name, entry.jitted, entry.args,
                                  runs=max(2, (runs or self.runs) // 2), hook=hook,
                                  device=self.device)
            else:
                wu = self.warmup if warmup is None else warmup
                if not cache.get("executable_reused"):
                    # steady state only after a fresh compile's first calls
                    wu += self.compile_warmup
                final_args: List[Tuple] = []
                phase_log = [] if prof else None
                trace: Dict[str, Any] = {}
                m = measure(scenario.name, entry.step, entry.args, entry.donate,
                            runs=runs or self.runs, warmup=wu, hook=hook,
                            jitted=entry.jitted, final_args=final_args,
                            phase_log=phase_log, device_trace=trace, device=self.device,
                            compiled=True)
                if self.reuse and final_args:
                    # the donated cache was updated in place and threaded: keep
                    # the threaded args for the next measurement
                    entry.args = final_args[0]
            rr = RunResult.from_measurement(
                scenario, m, wall_s=time.perf_counter() - t0, cache=cache)
            if cache.get("executable_reused"):
                rr.compile_us = 0.0
            if scenario.mode != "eager":
                # this process's compiles so far (a worker's reach the
                # dispatcher through its records)
                rr.extra["compile_budget"] = compile_budget()
            if cov:
                rr.extra.update(cov)
            if prof and scenario.mode == "eager":
                # no compiled step to trace, as in the reference
                rr.extra["prof_skipped"] = "eager"
            elif prof:
                # the trace is of the compiled step; the cost pass runs it
                # under a dispatch mode, where Dynamo runs it uncompiled
                rr.extra.update(self._profile_extra(
                    scenario, phase_log, trace,
                    lambda: analyze_step(entry.jitted, final_args[0], entry.donate)))
        except Exception as e:  # noqa: BLE001 — fault containment per cell
            self.stats.errors += 1
            # a failed measure may have left a half-updated cache: evict
            self._execs.pop(scenario, None)
            rr = RunResult.from_error(scenario, f"{type(e).__name__}: {e}",
                                      wall_s=time.perf_counter() - t0)
        return self._finalize(rr, extra, record)

    def _coverage_extra(self, scenario: Scenario,
                        entry: _ExecEntry) -> Dict[str, int]:
        """Per-scenario torch API counts (``extra["cov_*"]``) and the
        process-union gauge — the cheap seed for the coverage loop.

        The reference swallows a failed pass ("coverage is advisory");
        here the pass runs the step, on the card through the kernels, and a
        swallowed CUDA error would stay with the process and hide a kernel
        fault, so an exception reaches ``run``, which makes the cell an
        error record."""
        prims = self._cov_cache.get(scenario)
        if prims is None:
            from repro_torch.core.coverage import step_surfaces
            api, _ = step_surfaces(entry.step, entry.args, entry.mutable)
            prims = frozenset(api)
            self._cov_cache[scenario] = prims
        new = prims - self._cov_union
        self._cov_union |= prims
        metrics_registry().set_gauge("fleet_cov_union_primitives",
                                     len(self._cov_union))
        return {"cov_primitives": len(prims), "cov_new_primitives": len(new)}

    # ---- measured profiling ---------------------------------------------

    def _profile_extra(self, cost_key: Any, phase_log, trace: Dict[str, Any],
                       analyze: Callable[[], HloCost], *, kind: str = "step",
                       wall_s: float = 0.0) -> Dict[str, Any]:
        """The ``extra["prof_*"]`` payload for one profiled execution:
        timeline from the measured ``phase_log`` plus op-class attribution
        from the step's (cached) cost and the trace's class times.  A
        failed trace or cost pass degrades to ``prof_error`` — profiling
        must never turn a good measurement into an error record."""
        error = None
        cost = self._prof_costs.get(cost_key)
        if cost is None:
            try:
                cost = analyze()
                if self.reuse:
                    self._prof_costs[cost_key] = cost
            except Exception as e:  # noqa: BLE001 — profile degrades, cell stays ok
                cost = HloCost()
                error = f"{type(e).__name__}: {e}"
        extra = profile_extra(phase_log, cost, kind=kind, wall_s=wall_s,
                              device_trace=trace, device=self.device)
        if error:
            extra["prof_error"] = error
        return extra

    def _finalize(self, rr: RunResult, extra: Optional[Dict[str, Any]],
                  record: bool) -> RunResult:
        """Shared result epilogue: merge extras, stamp provenance, record."""
        if extra:
            rr.extra.update(extra)
        stamp(rr, self.device)
        if record and self.store is not None:
            self.store.append(rr)
        return rr

    # ---- serving path ----------------------------------------------------

    def _serve_engine_for(self, scenario: Scenario, built: Built,
                          max_len: int) -> Tuple[Any, bool]:
        """The cached (compiled) engine for a serve or loadgen cell;
        returns (engine, reused)."""
        from repro_torch.launch.serve import ServeEngine
        key = (scenario.build_key(), scenario.mode, max_len,
               scenario.admission)
        if self.reuse and key in self._serve_engines:
            self.stats.executable_cache_hits += 1
            return self._serve_engines[key], True
        engine = ServeEngine(built, slots=scenario.slots, max_len=max_len,
                             donate=scenario.mode == "jit_donated",
                             admission=scenario.admission)
        self.stats.executable_builds += 1
        if self.reuse:
            self._serve_engines[key] = engine
        return engine, False

    def _run_serve(self, scenario: Scenario, *,
                   hook: Optional[RegressionHook] = None,
                   record: bool = True, profile: bool = False,
                   extra: Optional[Dict[str, Any]] = None) -> RunResult:
        """One serving cell: regenerate the scenario's trace, replay it
        through the (cached) engine, and fold the latency distribution into
        a RunResult — ``median_us``/``mean_us``/``p10_us``/``p90_us`` are
        per-token decode latencies; TTFT/per-token p50/p95/p99 and
        throughput land under the well-known ``extra`` keys.

        ``task="loadgen"`` is serve under transformed load: the trace is
        sharded (``scenario.split``), then its virtual arrival clock scaled
        by the offered load (``scenario.load``); the record adds
        ``offered_load`` and ``split``.  A measured replay that compiled
        (``admit_new_shapes``: a load reached an admission shape no earlier
        replay of the engine had) has its wall folded into ``compile_us``
        and is measured again; a second replay that still compiles makes
        the cell an error record.

        ``profile=True`` splits every decode step of the measured replay
        (``ServeEngine.run(phase_log=...)``) and attributes it over the
        decode step's op classes; replay wall time outside decode steps
        (admission, prefill, queue management) is the profile's idle
        share."""
        from repro_torch.launch.serve import summarize_metrics
        from repro_torch.runner.loadgen import scale_arrivals, shard_requests
        t0 = time.perf_counter()
        self.stats.scenarios_run += 1
        key = None
        try:
            spec = spec_for_scenario(scenario)
            hits0 = self.stats.model_cache_hits
            built = self.built_for(scenario.arch, dtype=scenario.dtype,
                                   mode=scenario.mode)
            model_reused = self.stats.model_cache_hits > hits0
            reqs = generate_trace(spec, vocab=built.cfg.vocab)
            if scenario.task == "loadgen":
                reqs = scale_arrivals(shard_requests(reqs, scenario.split),
                                      scenario.load)
                if not reqs:
                    raise ValueError(f"split {scenario.split!r} leaves an empty "
                                     f"shard of {spec.requests} requests")
            # sized for the whole replay: a row never needs more than its
            # own prompt + budget (+ the vlm prefix)
            prefix = built.cfg.n_prefix if built.cfg.family == "vlm" else 0
            max_len = cache_len_bound(reqs, prefix=prefix)
            key = (scenario.build_key(), scenario.mode, max_len,
                   scenario.admission)
            engine, engine_reused = self._serve_engine_for(scenario, built,
                                                           max_len)
            cache = {"model_reused": model_reused or engine_reused,
                     "executable_reused": engine_reused}
            compile_us = 0.0
            if not engine_reused:
                # untimed warm replay on a fresh engine (its compiles,
                # recorded as compile_us), so the measured replay's latency
                # samples are steady-state
                tc = time.perf_counter()
                engine.run(reqs)
                compile_us = (time.perf_counter() - tc) * 1e6
            for attempt in range(2):
                phase_log = [] if profile else None
                trace: Dict[str, Any] = {}
                out = engine.run(reqs, hook=hook, phase_log=phase_log,
                                 device_trace=trace)
                if not out["admit_new_shapes"]:
                    break
                if attempt:
                    raise RuntimeError(
                        f"{scenario.name}: the replay compiled again when measured "
                        f"again ({out['admit_new_shapes']} frames): no steady state")
                # this load reached shapes no earlier replay compiled: the
                # replay paid their compiles; the rerun is shape-complete,
                # the replay being deterministic
                compile_us += out["wall_s"] * 1e6
            sx = summarize_metrics(out)
            plens = sorted(len(r.prompt) for r in reqs)
            sx.update(trace=scenario.trace, slots=scenario.slots,
                      tokens=out["tokens_by_rid"],
                      prompt_len_p50=percentile(plens, 50),
                      prompt_len_p95=percentile(plens, 95))
            sx["capture"] = dataclasses.asdict(capture_spec(
                reqs, seed=spec.seed, source=f"capture:{scenario.name}"))
            if scenario.task == "loadgen":
                sx.update(offered_load=scenario.load, split=scenario.split)
            sx["compiled"] = engine.compiled
            sx["compile_budget"] = compile_budget()
            if profile:
                sx.update(self._profile_extra(
                    ("serve-cost",) + key, phase_log, trace,
                    lambda: _decode_cost(engine, reqs), kind="decode_step",
                    wall_s=out["wall_s"]))
            lats = out["tok_lat_s"] or out["ttft_s"]
            rr = RunResult(
                name=scenario.name, bench=scenario.bench, arch=scenario.arch,
                task=scenario.task, batch=scenario.batch, seq=scenario.seq,
                dtype=scenario.dtype, mode=scenario.mode, status="ok",
                median_us=percentile(lats, 50) * 1e6,
                mean_us=sum(lats) / len(lats) * 1e6,
                p10_us=percentile(lats, 10) * 1e6,
                p90_us=percentile(lats, 90) * 1e6,
                compile_us=compile_us, runs=out["requests"],
                wall_s=time.perf_counter() - t0, cache=cache,
                ts=time.time(), extra=sx)
        except Exception as e:  # noqa: BLE001 — fault containment per cell
            self.stats.errors += 1
            # the engine's in-place KV cache may be half-updated: evict it
            if key is not None:
                self._serve_engines.pop(key, None)
            rr = RunResult.from_error(scenario, f"{type(e).__name__}: {e}",
                                      wall_s=time.perf_counter() - t0)
        return self._finalize(rr, extra, record)

    def run_matrix(self, matrix: ScenarioMatrix, *,
                   hooks: Optional[Dict[str, RegressionHook]] = None,
                   runs: Optional[int] = None,
                   warmup: Optional[int] = None,
                   jobs: Optional[int] = None,
                   cluster: Optional[str] = None,
                   profile: Optional[bool] = None) -> List[RunResult]:
        """Run every scenario of the matrix; hooks are keyed by benchmark
        name ("arch/task") or full scenario name.

        ``jobs=N`` (default: the runner's ``jobs``) shards the scenarios
        across N persistent worker subprocesses, grouped by build_key so
        each worker keeps its caches hot (``runner/pool.py``); results
        come back in matrix order with ``extra["shard"]`` set.
        ``jobs<=1`` is the serial in-process path.  ``cluster`` (default:
        the runner's; overrides ``jobs``) dispatches across
        socket-connected workers instead (``runner/cluster/``); results
        carry ``extra["host"]``.  ``profile`` (default: the runner's
        setting) profiles every cell; under dispatch it rides in each
        worker job.
        """
        scenarios = matrix.expand()
        jobs = self.jobs if jobs is None else jobs
        cluster = self.cluster if cluster is None else cluster
        extras = self._matrix_extras(matrix, scenarios)
        if cluster and scenarios:
            return self._run_clustered(scenarios, hooks=hooks, runs=runs,
                                       warmup=warmup, cluster=cluster,
                                       profile=profile, extras=extras)
        if jobs and jobs > 1 and scenarios:
            # even a single cell goes through the pool: the caller opted
            # into worker fault containment and shard metadata
            return self._run_sharded(scenarios, hooks=hooks, runs=runs,
                                     warmup=warmup, jobs=jobs,
                                     profile=profile, extras=extras)
        out = []
        for sc in scenarios:
            hook = (hooks or {}).get(sc.name) or (hooks or {}).get(sc.bench)
            out.append(self.run(sc, hook=hook, runs=runs, warmup=warmup,
                                profile=profile, extra=extras.get(sc.name)))
        return out

    @staticmethod
    def _matrix_extras(matrix: ScenarioMatrix,
                       scenarios: List[Scenario]) -> Dict[str, Dict[str, Any]]:
        """Per-cell extras from the matrix's expansion (the
        ``slots_fallback`` marker of a ``slots="auto"`` resolution that
        fell back), attached to each result before it is recorded, on
        every transport."""
        fb = matrix.slots_fallback()
        return {sc.name: {"slots_fallback": fb[sc.name]}
                for sc in scenarios if sc.name in fb}

    def _dispatch_config(self) -> Dict[str, Any]:
        """What every worker is started with: this runner's measurement
        protocol and device, and this process's float32 matmul precision
        (the worker's numerics, and a key of Inductor's cache: a worker at
        another precision misses every graph this process compiled)."""
        return dict(runs=self.runs, warmup=self.warmup,
                    compile_warmup=self.compile_warmup, reuse=self.reuse,
                    measure_fence=self.measure_fence, device=str(self.device),
                    matmul_precision=torch.backends.cuda.matmul.fp32_precision)

    def _run_sharded(self, scenarios: List[Scenario], *,
                     hooks: Optional[Dict[str, RegressionHook]],
                     runs: Optional[int], warmup: Optional[int], jobs: int,
                     profile: Optional[bool] = None,
                     extras: Optional[Dict[str, Dict[str, Any]]] = None) -> List[RunResult]:
        """Dispatch a scenario batch to the persistent shard pool; the pool
        (and its workers' warm caches) lives until ``close()``."""
        if self._pool is not None and self._pool.jobs != jobs:
            self._pool.close()
            self._pool = None
        if self._pool is None:
            self._pool = ShardScheduler(jobs, **self._dispatch_config())
        record = self.store.append if self.store is not None else None
        prof = self.profile if profile is None else profile
        results, run_stats = self._pool.run(scenarios, hooks=hooks, runs=runs,
                                            warmup=warmup, profile=prof,
                                            on_result=record, steal=self.steal,
                                            extras=extras)
        self.stats.merge(run_stats)
        return results

    def _run_clustered(self, scenarios: List[Scenario], *,
                       hooks: Optional[Dict[str, RegressionHook]],
                       runs: Optional[int], warmup: Optional[int],
                       cluster: str,
                       profile: Optional[bool] = None,
                       extras: Optional[Dict[str, Dict[str, Any]]] = None) -> List[RunResult]:
        """Dispatch a scenario batch to the cluster coordinator; the
        coordinator (and for ``local:N`` its worker subprocesses with
        their warm caches) lives until ``close()``, like the pool."""
        from repro_torch.runner.cluster import ClusterScheduler
        if self._cluster is not None and self._cluster.spec != cluster:
            self._cluster.close()
            self._cluster = None
        if self._cluster is None:
            self._cluster = ClusterScheduler(cluster, **self._dispatch_config())
        record = self.store.append if self.store is not None else None
        prof = self.profile if profile is None else profile
        results, run_stats = self._cluster.run(scenarios, hooks=hooks,
                                               runs=runs, warmup=warmup,
                                               profile=prof, on_result=record,
                                               extras=extras)
        self.stats.merge(run_stats)
        return results

    # ---- subprocess isolation -------------------------------------------

    def _run_isolated(self, scenario: Scenario, *,
                      hook: Optional[RegressionHook] = None,
                      runs: Optional[int] = None,
                      warmup: Optional[int] = None,
                      record: bool = True, timeout: int = 1200,
                      profile: bool = False,
                      extra: Optional[Dict[str, Any]] = None) -> RunResult:
        """One scenario in its own interpreter on this runner's device: a
        crash (a kernel fault, OOM, ...) becomes an error record instead
        of killing the sweep.  The measurement config is forwarded, and
        the worker's ``RunnerStats`` come back in the payload and are
        merged."""
        t0 = time.perf_counter()
        fd, out = tempfile.mkstemp(suffix=".json", prefix="repro_torch_runner_")
        os.close(fd)
        cmd = [sys.executable, "-m", "repro_torch.runner.worker",
               "--scenario", json.dumps(scenario.to_dict()),
               "--runs", str(runs or self.runs),
               "--warmup", str(self.warmup if warmup is None else warmup),
               "--compile-warmup", str(self.compile_warmup),
               "--device", str(self.device),
               "--matmul-precision", torch.backends.cuda.matmul.fp32_precision,
               "--json", out]
        if not self.reuse:
            cmd.append("--no-reuse")
        if profile:
            cmd.append("--profile")
        if hook is not None:
            cmd += ["--slowdown-s", str(hook.slowdown_s),
                    "--leak-bytes", str(hook.leak_bytes)]
        try:
            r = subprocess.run(cmd, env=_subprocess_env(), capture_output=True,
                               text=True, timeout=timeout)
            if r.returncode == 0 and os.path.getsize(out):
                with open(out) as f:
                    payload = json.load(f)
                rr = RunResult.from_dict(payload["result"])
                worker_stats = payload.get("stats") or {}
                rr.wall_s = time.perf_counter() - t0
                rr.extra["isolated"] = True
                rr.extra["worker_stats"] = worker_stats
                self.stats.merge(worker_stats)
            else:
                self.stats.scenarios_run += 1
                self.stats.errors += 1
                rr = RunResult.from_error(
                    scenario, f"worker exit {r.returncode}: {r.stderr[-500:]}",
                    wall_s=time.perf_counter() - t0)
        except subprocess.TimeoutExpired:
            self.stats.scenarios_run += 1
            self.stats.errors += 1
            rr = RunResult.from_error(scenario, f"worker timeout after {timeout}s",
                                      wall_s=time.perf_counter() - t0)
        finally:
            if os.path.exists(out):
                os.remove(out)
        # the worker stamped its own record; _finalize fills error records
        return self._finalize(rr, extra, record)

    def run_dryrun(self, *args, **kwargs):
        raise NotImplementedError("the derived (dry-run) tier is not ported "
                                  "yet (ROADMAP Queue 1, slice 7)")


def _decode_cost(engine: Any, reqs: List[Any]) -> HloCost:
    """The op-class cost of one of the engine's decode steps over the
    trace's first wave (``ServeEngine.decode_probe``)."""
    with engine.decode_probe(reqs) as (step, _):
        return analyze_step(step)
